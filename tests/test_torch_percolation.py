"""PyTorch port, percolation: the bit-packed fill (``ops/packfill.py``), the
dilation and raster fills and the methods of ``percolation_mask``
(``ops/floodfill.py``), and the port's own binding of the native BFS
(``io/native.py``), against the JAX package and the host labelling on the
same inputs.

Everything here is exact: packed words bit for bit (the port's int32 words
viewed as JAX's uint32), masks cell for cell, counts and ``active_vf``
equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from openimpala_tpu.io import native as j_native  # noqa: E402
from openimpala_tpu.ops import floodfill as JF  # noqa: E402
from openimpala_tpu.ops import packfill as JP  # noqa: E402
from openimpala_tpu_torch.io import native as p_native  # noqa: E402
from openimpala_tpu_torch.ops import floodfill as PF  # noqa: E402
from openimpala_tpu_torch.ops import packfill as PP  # noqa: E402

# words at the int32 seams: INT_MAX, all ones (-1), the top bit alone
# (INT_MIN), and their neighbours
EDGE_WORDS = [0x7FFFFFFF, 0xFFFFFFFF, 0x80000000, 0x00000000, 0x00000001,
              0x7FFFFFFE, 0xFFFFFFFE, 0x80000001, 0xC0000000, 0x0000FFFF,
              0xFFFF0000, 0x55555555, 0xAAAAAAAA, 0x3FFFFFFF]


def _p(words_u32):
    """JAX uint32 words as the port's int32 words (the same bits)."""
    return torch.from_numpy(np.array(words_u32).view(np.int32))


def _bits(t):
    return t.numpy().view(np.uint32)


def _rand_words(rng, shape):
    return rng.integers(0, 2 ** 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _host_active(phase_ok, d):
    if not (phase_ok[JF._face_slices(d, True)].any()
            and phase_ok[JF._face_slices(d, False)].any()):
        return np.zeros(phase_ok.shape, bool)
    ri, ro = JF.flood_fill_host(phase_ok, d)
    return ri & ro


@pytest.mark.parametrize("X", [24, 32, 33, 40])
def test_pack_unpack_bit_exact(X):
    m = np.random.default_rng(X).random((X, 6, 10)) < 0.5
    want = np.asarray(JP.pack_x(jnp.asarray(m)))
    got = PP.pack_x(torch.from_numpy(m))
    assert got.dtype == torch.int32 and got.shape == (-(-X // 32), 6, 10)
    np.testing.assert_array_equal(_bits(got), want)
    back = PP.unpack_x(got, X)
    assert back.dtype == torch.bool
    np.testing.assert_array_equal(back.numpy(), m)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(JP.unpack_x(jnp.asarray(want), X)))


@pytest.mark.parametrize("shape", [(2, 7, 9), (3, 16, 5), (1, 33, 4)])
def test_fill_round_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    o = _rand_words(rng, shape)
    r = _rand_words(rng, shape) & o & _rand_words(rng, shape)
    want = np.asarray(JP.fill_round(jnp.asarray(o), jnp.asarray(r)))
    got = PP.fill_round(_p(o), _p(r))
    np.testing.assert_array_equal(_bits(got), want)


def test_edge_words_through_runs_and_sweeps():
    """INT_MAX, -1 and INT_MIN through the int32 arithmetic: ``o + 1``
    must wrap, right shifts must be logical, the top bit must count as
    the generate bit."""
    w = np.array(EDGE_WORDS, np.uint32)
    # _low_run's o + 1 wraps from INT_MAX to INT_MIN as the unsigned add
    assert PP._low_run(torch.tensor([0x7FFFFFFF], dtype=torch.int32)).item() \
        == 0x7FFFFFFF
    for fn in ("_low_run", "_high_run"):
        np.testing.assert_array_equal(
            _bits(getattr(PP, fn)(_p(w))),
            np.asarray(getattr(JP, fn)(jnp.asarray(w))), err_msg=fn)
    for k in (1, 2, 4, 8, 16, 31):
        np.testing.assert_array_equal(_bits(PP._srl(_p(w), k)), w >> k)
    # the words as X planes of a column: every pair of neighbours crosses
    # a word seam, in both directions and from every seed
    o = np.stack([w, np.roll(w, 3), np.full_like(w, 0xFFFFFFFF)])[:, :, None]
    for seed in (w, np.full_like(w, 1), np.full_like(w, 0x80000000)):
        r = np.stack([seed, seed, seed])[:, :, None] & o
        for reverse in (False, True):
            want = np.asarray(JP._sweep_x(jnp.asarray(o), jnp.asarray(r),
                                          reverse))
            got = PP._sweep_x(_p(o), _p(r), reverse)
            np.testing.assert_array_equal(_bits(got), want)


@pytest.mark.parametrize("shape", [(64, 16, 16), (100, 12, 16),
                                   (33, 17, 19)])
def test_oneshot_matches_jax_and_host(shape):
    rng = np.random.default_rng(shape[0])
    for por in (0.35, 0.6):
        phase_ok = rng.random(shape) < por
        for d in (0, 1, 2):
            j_active, j_counts = JP.percolation_oneshot_packed(
                jnp.asarray(phase_ok), d)
            active, n, rounds = PP.percolation_oneshot_packed(
                torch.from_numpy(phase_ok), d)
            np.testing.assert_array_equal(active.numpy(),
                                          np.asarray(j_active))
            np.testing.assert_array_equal(active.numpy(),
                                          _host_active(phase_ok, d))
            assert n.dtype == torch.int64
            assert int(n) == int(np.asarray(j_counts).sum())
            assert rounds >= 2


@pytest.mark.parametrize("method", ["device", "native"])
@pytest.mark.parametrize("direction", [0, 1, 2])
def test_methods_match_host(blob_phase, method, direction):
    vol = (np.random.default_rng(11).random((37, 20, 18)) < 0.45).astype(
        np.uint8)
    for phase in (blob_phase, vol):
        want, want_vf = PF.percolation_mask(phase, 1, direction,
                                            method="host")
        got, got_vf = PF.percolation_mask(phase, 1, direction, method=method,
                                          device="cpu")
        if method == "device":
            assert isinstance(got, torch.Tensor) and got.dtype == torch.bool
            got = got.numpy()
        else:
            assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, want)
        assert got_vf == want_vf
        j_got, j_vf = JF.percolation_mask(phase, 1, direction, method="host")
        np.testing.assert_array_equal(got, np.asarray(j_got))
        assert got_vf == j_vf


def test_device_method_takes_tensors_and_stays_there(blob_phase):
    t = torch.from_numpy(blob_phase)
    got, vf = PF.percolation_mask(t, 1, 2, method="device")
    want, want_vf = PF.percolation_mask(blob_phase, 1, 2, method="host")
    assert got.device == t.device
    np.testing.assert_array_equal(got.numpy(), want)
    assert vf == want_vf
    # a numpy phase goes up as uint8 where its values fit
    assert PF.upload_phase(blob_phase, "cpu").dtype == torch.uint8
    wide = blob_phase * 300
    assert PF.upload_phase(wide, "cpu").dtype == torch.int32
    np.testing.assert_array_equal(
        PF.percolation_mask(wide, 300, 2, method="device",
                            device="cpu")[0].numpy(), want)
    # an id a uint8 volume cannot hold matches nothing
    assert PF.percolation_mask(blob_phase, 257, 0, method="device",
                               device="cpu")[1] == 0.0


def _serpentine(n):
    phase = np.zeros((n, n, 3), np.int8)
    for i in range(n):  # serpentine in the (X, Y) plane at Z=1
        phase[i, :, 1] = 1 if i % 2 == 0 else 0
        if i % 4 == 1:
            phase[i, n - 1, 1] = 1
        elif i % 4 == 3:
            phase[i, 0, 1] = 1
    return phase


def _serpentine_x(X, Y):
    phase = np.zeros((X, Y, 3), bool)
    for j in range(Y):  # direction reversals across the word seams
        phase[:, j, 1] = j % 2 == 0
        if j % 4 == 1:
            phase[X - 1, j, 1] = True
        elif j % 4 == 3:
            phase[0, j, 1] = True
    return phase


def test_serpentines_take_jaxs_rounds():
    for phase in (_serpentine(16) == 1, _serpentine_x(96, 10)):
        active, n, rounds = PP.percolation_oneshot_packed(
            torch.from_numpy(phase), 0)
        want = _host_active(phase, 0)
        np.testing.assert_array_equal(active.numpy(), want)
        assert int(n) == int(want.sum()) > 0
        np.testing.assert_array_equal(
            active.numpy(),
            np.asarray(JP.percolation_oneshot_packed(jnp.asarray(phase),
                                                     0)[0]))
        o = JP.pack_x(jnp.asarray(phase))
        outlet = phase.shape[0] - 1
        _, j_rounds = JP._double_fill(
            o, JP._face_seeds_packed(o, 0, 0),
            lambda rin: JP._face_seeds_packed(rin, outlet, 0),
            JP.pack_x(jnp.asarray(phase)).shape[0] * 32 + sum(
                phase.shape[1:]) + 2)
        assert rounds == int(j_rounds) >= 4


def test_round_cap_stops_where_jax_stops():
    """A cap below what the serpentine needs: both packages stop after the
    same rounds with the same (unfinished) words."""
    phase = _serpentine(16) == 1
    o_j = JP.pack_x(jnp.asarray(phase))
    o_p = PP.pack_x(torch.from_numpy(phase))
    for cap in (1, 2, 3, 5):
        j_words, j_it = JP._double_fill(
            o_j, JP._face_seeds_packed(o_j, 0, 0),
            lambda rin: JP._face_seeds_packed(rin, 15, 0), cap)
        p_words, p_it = PP._double_fill(
            o_p, PP._face_seeds_packed(o_p, 0, 0),
            lambda rin: PP._face_seeds_packed(rin, 15, 0), cap)
        np.testing.assert_array_equal(_bits(p_words), np.asarray(j_words))
        assert p_it == int(j_it)
        j_r, j_n = JP.packed_fill(o_j, JP._face_seeds_packed(o_j, 0, 0), cap)
        p_r, p_n = PP.packed_fill(o_p, PP._face_seeds_packed(o_p, 0, 0), cap)
        np.testing.assert_array_equal(_bits(p_r), np.asarray(j_r))
        assert p_n == int(j_n)


def test_empty_face_dead_end_and_cross_word_channel():
    solid = np.zeros((8, 4, 4), np.int32)
    channel = solid.copy()
    channel[:, 1, 1] = 1
    pocket = np.zeros((8, 5, 5), np.int32)
    pocket[:, 1, 1] = 1
    pocket[3:5, 3, 3] = 1
    for method in ("device", "native", "host"):
        for phase, d, vf in ((solid, 0, 0.0), (channel, 1, 0.0),
                             (channel, 0, 8 / 128)):
            mask, got_vf = PF.percolation_mask(phase, 1, d, method=method,
                                               device="cpu")
            assert got_vf == vf and int(np.asarray(mask).sum()) == round(
                vf * phase.size)
        mask = np.asarray(PF.percolation_mask(pocket, 1, 0, method=method,
                                              device="cpu")[0])
        assert mask[:, 1, 1].all() and not mask[3:5, 3, 3].any()
    long = np.zeros((70, 4, 4), bool)
    long[:, 1, 1] = True
    long[40, 1, 1] = False  # broken in the middle of word 1
    active, n, _ = PP.percolation_oneshot_packed(torch.from_numpy(long), 0)
    assert int(n) == 0 and not active.any()
    long[40, 1, 1] = True
    active, n, _ = PP.percolation_oneshot_packed(torch.from_numpy(long), 0)
    assert int(n) == 70 and bool(active[:, 1, 1].all())


def test_dilation_and_raster_fills_match_host(blob_phase):
    phase_ok = blob_phase == 1
    for d in (0, 1, 2):
        seeds = np.zeros(phase_ok.shape, bool)
        seeds[JF._face_slices(d, True)] = True
        want, _ = JF.flood_fill_host(phase_ok, d)
        for fill in (PF.flood_fill_device, PF.flood_fill_device_raster):
            got, steps = fill(torch.from_numpy(phase_ok),
                              torch.from_numpy(seeds))
            np.testing.assert_array_equal(got.numpy(), want)
        j_got, j_steps = JF.flood_fill_device(jnp.asarray(phase_ok),
                                              jnp.asarray(seeds))
        got, steps = PF.flood_fill_device(torch.from_numpy(phase_ok),
                                          torch.from_numpy(seeds))
        assert steps == int(j_steps)
    # the serpentine: rounds track turns, not cells; the dilation needs its
    # cap lifted to finish (the reference's sum(dims) + 2 undershoots)
    phase = _serpentine(16)
    seeds = np.zeros(phase.shape, bool)
    seeds[0] = True
    pok = torch.from_numpy(phase == 1)
    r_raster, rounds = PF.flood_fill_device_raster(pok, torch.from_numpy(seeds))
    r_dilate, _ = PF.flood_fill_device(pok, torch.from_numpy(seeds),
                                       max_iter=10_000)
    np.testing.assert_array_equal(r_raster.numpy(), r_dilate.numpy())
    assert rounds <= 16 + 2
    j_raster, j_rounds = JF.flood_fill_device_raster(jnp.asarray(phase == 1),
                                                     jnp.asarray(seeds))
    np.testing.assert_array_equal(r_raster.numpy(), np.asarray(j_raster))
    assert rounds == int(j_rounds)
    full = torch.ones((6, 6, 6), dtype=torch.bool)
    seeds = torch.zeros((6, 6, 6), dtype=torch.bool)
    seeds[0] = True
    mask, steps = PF.flood_fill_device(full, seeds)
    assert bool(mask.all()) and steps <= 6 + 6 + 6 + 2


@pytest.fixture
def jax_native():
    """The JAX package's native library, which the binding is held
    against (decided inside the test, not at import)."""
    if not j_native.available():
        pytest.skip("no C++ toolchain for the JAX package's native library")
    return j_native


def test_native_binding_matches_jax_and_host(jax_native, blob_phase):
    rng = np.random.default_rng(4)
    assert p_native.get_lib() is not None
    assert p_native.lib_path().parent == p_native.BUILD_DIR
    for d in (0, 1, 2):
        ok = np.ascontiguousarray(blob_phase == 1, np.int8)
        got, n = p_native.percolation_mask(ok, d)
        want, wn = j_native.percolation_mask(ok, d)
        np.testing.assert_array_equal(got, want)
        assert n == wn == int(_host_active(blob_phase == 1, d).sum())
        for dt in (np.int8, np.uint8, np.int32):
            ph = blob_phase.astype(dt)
            got, n = p_native.percolation_mask_phase(ph, 1, d)
            np.testing.assert_array_equal(got, _host_active(ph == 1, d))
            np.testing.assert_array_equal(
                got, j_native.percolation_mask_phase(ph, 1, d)[0])
    # no path: half the volume open, cut off from the outlet
    phase = np.zeros((8, 8, 8), np.int8)
    phase[:4] = 1
    mask, n = p_native.percolation_mask(phase, 0)
    assert n == 0 and not mask.any()
    # uint8 ids in [128, 255] ride the exact int8 reinterpretation
    ph = np.where(rng.random((16, 12, 8)) < 0.6, 200, 3).astype(np.uint8)
    got, n = p_native.percolation_mask_phase(ph, 200, 0)
    np.testing.assert_array_equal(got, _host_active(ph == 200, 0))
    assert n == int(got.sum())
    # outside the fused compare: a float volume, an id int8 cannot hold
    assert p_native.percolation_mask_phase(ph.astype(np.float32), 200,
                                           0) is None
    assert p_native.percolation_mask_phase(ph.astype(np.int8), 300, 0) is None
    for ph_, pid in ((ph.astype(np.float32), 200), (ph.astype(np.int64), 3)):
        got, vf = PF.percolation_mask(ph_, pid, 1, method="native")
        want, want_vf = PF.percolation_mask(ph_, pid, 1, method="host")
        np.testing.assert_array_equal(got, want)
        assert vf == want_vf


def test_native_raises_where_the_library_cannot_be_built(monkeypatch,
                                                         blob_phase):
    monkeypatch.setenv("CXX", "/nonexistent/g++")
    monkeypatch.setattr(p_native, "_lib", None)
    monkeypatch.setattr(p_native, "_error", None)
    assert p_native.get_lib() is None
    with pytest.raises(RuntimeError, match="native library is unavailable"):
        PF.percolation_mask(blob_phase, 1, 0, method="native")


def test_native_builds_without_openmp_where_the_compiler_lacks_it(
        jax_native, monkeypatch, tmp_path, blob_phase):
    """The second flag set (no ``-fopenmp``) serves where the first does
    not compile; the BFS is the same."""
    bad = ("-fno-such-flag-here",) + p_native.CXXFLAGS
    monkeypatch.setattr(p_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(p_native, "FLAG_SETS",
                        (bad, p_native.FLAG_SETS[1]))
    monkeypatch.setattr(p_native, "_lib", None)
    monkeypatch.setattr(p_native, "_error", None)
    assert p_native.get_lib() is not None
    assert not p_native.lib_path(bad).exists()
    got, vf = PF.percolation_mask(blob_phase, 1, 0, method="native")
    np.testing.assert_array_equal(got, _host_active(blob_phase == 1, 0))


def test_native_flags_are_the_makefiles():
    line = (p_native.SOURCE.parent / "Makefile").read_text().splitlines()[1]
    assert line.split("?=")[1].split() == list(p_native.CXXFLAGS)
    assert p_native.FLAG_SETS[0] == p_native.CXXFLAGS
    assert p_native.FLAG_SETS[1] == tuple(
        f for f in p_native.CXXFLAGS if f != "-fopenmp")


def test_auto_rule():
    assert PF.auto_method((512, 512, 512), "cpu") == "host"
    assert PF.auto_method((8, 8, 8), torch.device("cpu")) == "host"
    # on the card, the rule measured on the H100: the native BFS below 2^23
    # cells, the device fill from there
    for n, want in ((64, "native"), (128, "native"), (192, "native"),
                    (224, "device"), (256, "device"), (512, "device")):
        assert PF.auto_method((n, n, n), "cuda") == want
    assert PF.auto_method((2 ** 23, 1, 1), torch.device("cuda")) == "device"
    with pytest.raises(ValueError, match="unknown percolation method"):
        PF.percolation_mask(np.ones((4, 4, 4)), 1, 0, method="bogus")
