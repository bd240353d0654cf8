"""PyTorch port, the batched REV path: ``solve/batched.py`` and
``props/rev.py`` against the JAX package on the same crops.

Tolerances: D_eff tensors 1e-6 absolute (the golden tolerance; both solve to
1e-9 relative residual), per-lane iterations within 1 (the same bottom-form
recurrence; sums are taken in another order), ``converged`` equal, CSV rows
equal to the printed 8 decimals or within 1e-6."""

import itertools
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from openimpala_tpu.props import rev as JR  # noqa: E402
from openimpala_tpu.solve import batched as JB  # noqa: E402
from openimpala_tpu_torch.props import rev as PRV  # noqa: E402
from openimpala_tpu_torch.solve import batched as PB  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from make_sample_data import make_blobs  # noqa: E402


@pytest.fixture(scope="module")
def crops():
    """4 crops of 16^3 from one 32^3 blobs volume."""
    vol = make_blobs(32, 0.5, seed=4)
    return np.stack([vol[:16, :16, :16], vol[16:, :16, 8:24],
                     vol[8:24, 16:, 16:], vol[16:, 16:, :16]])


@pytest.mark.parametrize("k", [0, 2])
def test_batched_cell_problems_match_jax(crops, k):
    masks = crops == 1
    chi_j, rel_j, conv_j = JB.batched_cell_problems(
        jnp.asarray(masks), k, 1e-9, 2000)
    chi_p, rel_p, conv_p = PB.batched_cell_problems(
        torch.from_numpy(masks), k, 1e-9, 2000)
    assert chi_p.shape == masks.shape and chi_p.dtype == torch.float64
    assert conv_p.tolist() == np.asarray(conv_j).tolist() == [True] * 4
    assert float(rel_p.max()) <= 1e-9
    # chi is fixed up to a constant per connected pore component; the
    # tensor's integrand (central differences) does not see it, so compare
    # the gradients' sums through the D_eff test below and the residual here
    np.testing.assert_allclose(rel_p.numpy(), np.asarray(rel_j), rtol=0,
                               atol=1e-9)


def test_batched_cg_iterations_match_jax(crops):
    """One inner round of the lockstep PCG on the same right-hand sides:
    per-lane iteration counts within 1, converged lanes frozen."""
    from openimpala_tpu.ops.stencil import make_cell_problem_system as j_make
    from openimpala_tpu_torch.ops.stencil import (
        make_cell_problem_system as p_make)
    import jax

    masks = crops == 1
    js = jax.vmap(lambda a: j_make(a, 1, dtype=jnp.float32))(
        jnp.asarray(masks))
    ps = p_make(torch.from_numpy(masks), 1, dtype=torch.float32)
    np.testing.assert_array_equal(ps.r0_b.numpy(), np.asarray(js.r0_b))
    scale = np.sqrt((np.asarray(js.r0_b, np.float64) ** 2).sum(
        axis=(1, 2, 3)))
    r_lo = (np.asarray(js.r0_b, np.float64)
            / scale[:, None, None, None]).astype(np.float32)
    jm = JB._make_precond(js, jnp.asarray(r_lo), "cheby", 12)
    pm = PB._make_precond(ps, torch.from_numpy(r_lo), "cheby", 12)
    # a loose and a tight lane tolerance: lanes finish at different counts
    for eps in (1e-2, 1e-5):
        z_j, it_j, rel_j = JB._batched_cg(
            js, jnp.asarray(r_lo), jnp.ones((4,), jnp.float32), eps, 500, jm)
        z_p, it_p, rel_p = PB._batched_cg(
            ps, torch.from_numpy(r_lo), torch.ones(4), eps, 500, pm)
        assert np.abs(it_p.numpy() - np.asarray(it_j)).max() <= 1
        assert float(rel_p.max()) <= eps
        assert torch.isfinite(z_p).all()
        if np.array_equal(it_p.numpy(), np.asarray(it_j)):
            np.testing.assert_allclose(z_p.numpy(), np.asarray(z_j),
                                       rtol=0, atol=2e-3)


@pytest.mark.parametrize("dx", [(1.0, 1.0, 1.0), (1.0, 1.0, 2.0)])
def test_batched_deff_matches_jax(crops, dx):
    want, wconv = JB.batched_deff(crops, 1, group_size=2, dx=dx)
    got, conv = PB.batched_deff(crops, 1, group_size=2, dx=dx, device="cpu")
    assert got.shape == (4, 3, 3) and got.dtype == np.float64
    assert conv.tolist() == wconv.tolist() == [True] * 4
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # one group of four is the same as two groups of two
    whole, _ = PB.batched_deff(crops, 1, group_size=4, dx=dx, device="cpu")
    np.testing.assert_allclose(whole, got, rtol=0, atol=1e-8)


def test_batched_matches_sequential_solver(crops):
    """The batched Chebyshev PCG and the sequential multigrid solver solve
    the same problems."""
    from openimpala_tpu_torch import effective_diffusivity

    got, conv = PB.batched_deff(crops[:2], 1, device="cpu")
    for b in range(2):
        seq = effective_diffusivity(crops[b], 1, device="cpu")
        assert seq.converged and conv[b]
        np.testing.assert_allclose(got[b], seq.deff, rtol=0, atol=1e-6)


def test_frozen_and_empty_lanes_stay_finite(crops):
    """An all-solid crop (zero right-hand side, done at once) and a crop
    with a single isolated pore cell ride along with live lanes: no NaN
    anywhere, the empty lanes' tensors zero, the live lanes unchanged."""
    solid = np.zeros_like(crops[0])
    speck = np.zeros_like(crops[0])
    speck[3, 4, 5] = 1
    stack = np.stack([crops[0], solid, speck, crops[1]])
    got, conv = PB.batched_deff(stack, 1, group_size=4, device="cpu")
    want, wconv = JB.batched_deff(stack, 1, group_size=4)
    assert np.isfinite(got).all() and conv.all() and wconv.all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[1], np.zeros((3, 3)))
    alone, _ = PB.batched_deff(crops[:2], 1, group_size=2, device="cpu")
    np.testing.assert_allclose(got[[0, 3]], alone, rtol=0, atol=1e-8)


def test_jacobi_batch_and_budget(crops):
    """``precond="jacobi"`` of the batched solver, and a budget too small to
    converge: not converged, as in the JAX package."""
    masks = crops[:2] == 1
    _, rel_p, conv_p = PB.batched_cell_problems(
        torch.from_numpy(masks), 0, 1e-9, 25, precond="jacobi")
    _, rel_j, conv_j = JB.batched_cell_problems(
        jnp.asarray(masks), 0, 1e-9, 25, precond="jacobi")
    assert conv_p.tolist() == np.asarray(conv_j).tolist() == [False, False]
    np.testing.assert_allclose(rel_p.numpy(), np.asarray(rel_j), rtol=1e-3)


def test_auto_group_size_model():
    assert PB._auto_group_size((16, 16, 16), requested=3) == 3
    assert PB._auto_group_size((16, 16, 16), requested=0) == 1
    crop_bytes = 16 ** 3 * 4
    assert PB._auto_group_size(
        (16, 16, 16), budget_bytes=5 * PB.FIELDS_PER_CROP * crop_bytes) == 5
    assert PB._auto_group_size((16, 16, 16), budget_bytes=1) == 1
    # no card: the CPU budget
    assert PB._auto_group_size((64, 64, 64), device="cpu") == (
        PB.CPU_BUDGET_BYTES // (PB.FIELDS_PER_CROP * 64 ** 3 * 4))
    # the JAX package's model, given the same budget and fields per crop
    assert JB._auto_group_size(
        (16, 16, 16),
        budget_bytes=5 * JB.FIELDS_PER_CROP * crop_bytes) == 5


# -- props/rev.py -------------------------------------------------------------


def test_csv_and_samples_match_jax():
    assert PRV.CSV_HEADER == JR.CSV_HEADER
    assert PRV.AUTO_BATCH_MAX_CELLS == JR.AUTO_BATCH_MAX_CELLS
    d = np.arange(9.0).reshape(3, 3) / 7.0
    args = dict(sample_no=3, seed=(1, 2, 3), size_target=16,
                actual_size=(16, 16, 12), deff=d, converged=True)
    assert PRV.csv_row(PRV.RevSample(**args)) == JR.csv_row(
        JR.RevSample(**args))
    phase = np.zeros((40, 30, 12), np.int32)
    for sizes, n in (((16, 8), 5), ((64,), 2), ((4,), 3)):
        want = JR._draw_samples(phase, sizes, n,
                                np.random.default_rng(12345 + n), 0)
        got = PRV._draw_samples(phase, sizes, n,
                                np.random.default_rng(12345 + n), 0)
        assert got == want
    assert PRV._draw_samples(phase, (4,), 3, np.random.default_rng(0),
                             0) == []  # longest side below 8: skipped


def test_resolve_batch_truth_table():
    batches = ["auto", True, False, "true", "false", "ON", "0", "1", "no"]
    actuals = [(16, 16, 16), (96, 96, 96), (97, 96, 96)]
    kwargs = [None, {}, {"inner_dtype": None}, {"inner_dtype": "f32"}]
    for batch, actual, n, kw, method, precond in itertools.product(
            batches, actuals, (1, 2), kwargs, ("cg", "PCG", "fgmres"),
            ("auto", "jacobi")):
        assert PRV._resolve_batch(batch, actual, n, kw, method=method,
                                  precond=precond) == JR._resolve_batch(
            batch, actual, n, kw, method=method, precond=precond), (
            batch, actual, n, kw, method, precond)


@pytest.fixture(scope="module")
def rev_volume():
    return make_blobs(32, 0.5, seed=5)


@pytest.mark.parametrize("batch", ["auto", False])
def test_rev_study_matches_jax(rev_volume, batch, tmp_path):
    kw = dict(sizes=(16,), num_samples=3, batch=batch)
    want = JR.rev_study(rev_volume, 1, **kw)
    path = tmp_path / "rev.csv"
    got = PRV.rev_study(rev_volume, 1, csv_path=str(path), device="cpu",
                        **kw)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert (g.sample_no, g.seed, g.size_target, g.actual_size) == (
            w.sample_no, w.seed, w.size_target, w.actual_size)
        assert g.converged and w.converged
        np.testing.assert_allclose(g.deff, w.deff, rtol=0, atol=1e-6)
        grow, wrow = PRV.csv_row(g).split(","), JR.csv_row(w).split(",")
        assert grow[:8] == wrow[:8]
        for a, b in zip(grow[8:], wrow[8:]):
            assert a == b or abs(float(a) - float(b)) <= 1e-6
    lines = path.read_text().splitlines()
    assert lines[0] == PRV.CSV_HEADER
    assert lines[1:] == [PRV.csv_row(s) for s in got]


def test_rev_study_mixed_shapes_and_batch_true(rev_volume):
    """A size larger than one axis clips the box: two shapes, two groups;
    ``batch=True`` batches even a group of one."""
    vol = rev_volume[:, :, :12]
    kw = dict(sizes=(16, 10), num_samples=2, batch=True)
    want = JR.rev_study(vol, 1, **kw)
    got = PRV.rev_study(vol, 1, device="cpu", **kw)
    assert [g.actual_size for g in got] == [w.actual_size for w in want]
    assert {g.actual_size for g in got} == {(16, 16, 12), (10, 10, 10)}
    for g, w in zip(got, want):
        assert g.converged == w.converged is True
        np.testing.assert_allclose(g.deff, w.deff, rtol=0, atol=1e-6)


def test_rev_study_refuses_plotfiles(rev_volume, tmp_path):
    """``plotfile_dir`` (once refused) writes each sample's chi fields as
    the JAX package does: the crops run on the sequential solver, the same
    rows, and one HDF5 + XDMF pair per sample with the same datasets."""
    h5py = pytest.importorskip("h5py")
    kw = dict(sizes=(16,), num_samples=2)
    want = JR.rev_study(rev_volume, 1, plotfile_dir=str(tmp_path / "jax"),
                        **kw)
    got = PRV.rev_study(rev_volume, 1, plotfile_dir=str(tmp_path / "port"),
                        device="cpu", **kw)
    for g, w in zip(got, want):
        assert g.converged == w.converged is True
        np.testing.assert_allclose(g.deff, w.deff, rtol=0, atol=1e-6)
        base = f"rev_chi_s{g.sample_no}_sz{g.size_target}"
        with h5py.File(tmp_path / "port" / f"{base}.h5") as fp, \
                h5py.File(tmp_path / "jax" / f"{base}.h5") as fj:
            assert sorted(fp) == sorted(fj) == ["chi_x", "chi_y", "chi_z",
                                                "phase"]
            np.testing.assert_array_equal(fp["phase"][()], fj["phase"][()])
            for name in ("chi_x", "chi_y", "chi_z"):
                np.testing.assert_allclose(fp[name][()], fj[name][()],
                                           rtol=0, atol=1e-6)
        assert (tmp_path / "port" / f"{base}.xmf").read_text() == (
            tmp_path / "jax" / f"{base}.xmf").read_text()
