"""Homogenisation on X slabs (``openimpala_tpu_torch``: the periodic cell
problems, their default cycle and lanes, ``effective_diffusivity(mesh=)``),
the Z-page ingest and the distributed CLI, on four ``gloo`` ranks on the
CPU, held against the single-device port and the JAX package on the same
numpy inputs (the JAX side as ``tests/test_parallel.py`` runs it:
``make_mesh(n_devices=4)`` on conftest's virtual CPU devices, and the
single-device call).

Every rank-side case runs in ONE world of four processes of its own
(``parallel.spawn.World`` over ``parallel.checks.batch``), started when the
module's first test asks for it and joined with a timeout; the JAX and
single-device references are computed in this process meanwhile.

Tolerances: each rank's packed code and right-hand side equal its slab of
the single-device system bit for bit, ``b_norm`` 1e-12; one V-cycle
1e-10; the tensor's integrand sums 1e-12; D within 1e-6 of the JAX
package's sharded and single-device tensors and of the port's, iterations
within 2 per direction (sums over ranks add in another order), the same
bits on every rank; the Z-page ingest bit for bit; the CLI's printed
tensor 1e-7 (8 significant digits) of the single-process CLI's and 1e-6
of the JAX package's, ``results.txt`` equal to the single-process CLI's
and its tau 1e-6 of the JAX package's; the REV study's CSV and chi
plotfiles 1e-6 of the single-process CLI's.
"""

import re

import numpy as np
import pytest
import torch

import jax

from openimpala_tpu.parallel.mesh import make_mesh
from openimpala_tpu_torch.parallel import spawn

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs 4 virtual devices")

N = 4  # ranks
WORLD_TIMEOUT = 150.0  # seconds for the whole world, start-up included


def _mask(seed, shape, p=0.7):
    active = np.random.default_rng(seed).random(shape) < p
    active[:, 5, 3] = True
    return active


def _vol(seed, shape, p=0.7):
    """A two-phase int8 volume that percolates along every axis."""
    phase = (np.random.default_rng(seed).random(shape) < p).astype(np.int8)
    phase[:, 5, 5] = 1
    phase[5, :, 5] = 1
    phase[5, 5, :] = 1
    return phase


def _field(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape)


SYSTEM_SHAPE = (32, 12, 10)
SYSTEMS = [(k, dx) for dx in ((1.0, 1.0, 1.0), (1.0, 1.0, 2.0))
           for k in range(3)]
VCYCLE = {  # shape, dx, options; the level the slab cycle gathers at
    "even": ((32, 16, 16), (1.0, 1.0, 1.0), {}, 2),
    "odd": ((36, 16, 16), (1.0, 1.0, 1.0), {}, 0),  # slabs of 9
}
SUM_SHAPE = (32, 12, 10)
DEFF_SHAPE = (32, 12, 12)
DEFF_LANES = (True, False, "auto")
FALLBACK_SHAPE = (30, 12, 12)  # 30 over 4 ranks: no sharding
TIFF_SHAPE = (38, 16, 13)  # X padded to 40, Z 13 over 4 ranks
CLI_SHAPE = (32, 16, 12)
CLI_CASES = {"homogenization": {"calculation_method": "homogenization"},
             "flow_through": {"calculation_method": "flow_through",
                              "direction": "All"}}
# the REV study under the group (the ranks' cli job with every volume
# auto-sharded, AUTO_SHARD_MIN_CELLS 0): crops of 8^3 whose X divides the
# ranks, and plotfiles, which rank 0 alone asks for
REV_KEYS = {"calculation_method": "homogenization", "rev.do_study": 1,
            "rev.sizes": 8, "rev.num_samples": 2, "rev.write_plotfiles": 1}
KW = {"eps": 1e-9}
# global cell counts either side of the lanes gate's CPU budget (6 GiB at
# 198 B per cell for three lanes: 32.5e6 cells)
GATE_CELLS = (1000, 30_000_000, 40_000_000)
RAW_SHAPE = (30, 12, 10)  # X padded to 32 by the ingest; 30 % 4 != 0
# a cap below what the DEFF_SHAPE cell problems need
SLAB_MAXITER = 3


def _write_tiff(path, vol):
    from openimpala_tpu_torch.io.tiff_raw import write_tiff

    write_tiff(str(path), [vol[:, :, z].T for z in range(vol.shape[2])])


def _files(tmp):
    rng = np.random.default_rng(5)
    tif = (rng.random(TIFF_SHAPE) * 255).astype(np.uint8)
    _write_tiff(tmp / "z.tif", tif)
    cli = _vol(9, CLI_SHAPE, p=0.6).astype(np.uint8) * 200
    _write_tiff(tmp / "cli.tif", cli)
    inputs = {}
    for name, keys in list(CLI_CASES.items()) + [("rev", REV_KEYS)]:
        lines = ["filename = cli.tif", f"data_path = {tmp}/",
                 f"results_path = {tmp}/single_{name}/", "phase_id = 1",
                 "hypre.eps = 1e-9", "verbose = 1"]
        lines += [f"{k} = {v}" for k, v in keys.items()]
        path = tmp / f"{name}.inputs"
        path.write_text("\n".join(lines) + "\n")
        inputs[name] = path
    raw = (rng.random(RAW_SHAPE) * 255).astype(np.uint8)
    raw.transpose(2, 1, 0).tofile(tmp / "v.raw")
    (tmp / "raw.inputs").write_text(
        f"filename = v.raw\ndata_path = {tmp}/\nraw.width = "
        f"{RAW_SHAPE[0]}\nraw.height = {RAW_SHAPE[1]}\nraw.depth = "
        f"{RAW_SHAPE[2]}\nraw.datatype = UINT8\n")
    return {"tif": tif, "cli": cli, "inputs": inputs, "raw": raw}


def _jobs(tmp, files):
    jobs = []
    for k, dx in SYSTEMS:
        jobs.append(("cell_system", (_mask(2, SYSTEM_SHAPE), k, dx)))
    for name, (shape, dx, opts, _) in VCYCLE.items():
        jobs.append(("cell_vcycle", (_mask(4, shape), _field(6, shape), dx,
                                     opts)))
    jobs.append(("deff_sum", (_mask(8, SUM_SHAPE),
                              [_field(10 + i, SUM_SHAPE) for i in range(3)],
                              (1.0, 1.0, 2.0))))
    for lanes in DEFF_LANES:
        jobs.append(("deff", (_vol(7, DEFF_SHAPE), dict(KW, lanes=lanes))))
    jobs.append(("deff", (_vol(7, FALLBACK_SHAPE), KW)))
    jobs.append(("deff_padded_slab", (_vol(7, FALLBACK_SHAPE),)))
    jobs.append(("deff_slab", (_vol(7, DEFF_SHAPE), KW)))
    jobs.append(("zpart", (str(tmp / "z.tif"), 3)))
    for name in CLI_CASES:
        jobs.append(("cli", (str(files["inputs"][name]),
                             str(tmp / f"ranks_{name}"))))
    jobs.append(("cli", (str(files["inputs"]["rev"]), str(tmp / "ranks_rev"),
                         0)))
    jobs.append(("lanes_gate", (GATE_CELLS,)))
    jobs.append(("vf_counts", (str(tmp / "v.raw"), RAW_SHAPE,
                               str(tmp / "raw.inputs"))))
    # maxiter on slabs, through the lanes and the sequential loop (after
    # the other "deff" jobs, so their indices stay)
    for lanes in (True, False):
        jobs.append(("deff", (_vol(7, DEFF_SHAPE), dict(
            KW, maxiter=SLAB_MAXITER, lanes=lanes))))
    return jobs


class _Results:
    """The world's results, keyed by case; the world runs in the
    background until a test first asks."""

    def __init__(self, tmp):
        self.tmp = tmp
        self.files = _files(tmp)
        self.jobs = _jobs(tmp, self.files)
        self.world = spawn.World(
            "openimpala_tpu_torch.parallel.checks:batch", N,
            args=(self.jobs,), device="cpu", timeout=WORLD_TIMEOUT,
            workdir=tmp / "world", threads=1)
        self._by_rank = None

    def __call__(self, kind, index):
        """Every rank's result of the ``index``-th job of ``kind``."""
        if self._by_rank is None:
            self._by_rank = self.world.wait()
        pos = [i for i, (k, _) in enumerate(self.jobs) if k == kind][index]
        return [rank[pos] for rank in self._by_rank]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    res = _Results(tmp_path_factory.mktemp("torch_parallel_deff"))
    yield res
    if res._by_rank is None:  # nobody asked: still end the ranks
        res.world.wait()


def _cat(parts):
    return np.concatenate(parts, axis=0)


def _jax_mesh():
    return make_mesh(n_devices=N)


# ---------------------------------------------------------------------------
# the cell problems, their cycle and the tensor's sums
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("index,k,dx", [(i, k, dx) for i, (k, dx)
                                        in enumerate(SYSTEMS)])
def test_cell_problem_system_on_slabs(world, index, k, dx):
    from openimpala_tpu.ops.stencil import (
        make_cell_problem_system as jax_system)
    from openimpala_tpu_torch.ops.stencil import make_cell_problem_system

    active = _mask(2, SYSTEM_SHAPE)
    sys1 = make_cell_problem_system(torch.from_numpy(active), k, dx,
                                    dtype=torch.float64)
    got = world("cell_system", index)
    np.testing.assert_array_equal(_cat([c for c, _, _ in got]),
                                  sys1.code.float().numpy())
    np.testing.assert_array_equal(_cat([r for _, r, _ in got]),
                                  sys1.r0_b.numpy())
    for _, _, b_norm in got:
        assert b_norm == got[0][2]  # the same bits on every rank
        assert abs(b_norm - float(sys1.b_norm)) <= 1e-12 * float(sys1.b_norm)
    jsys = jax_system(jax.numpy.asarray(active), k, dx)
    np.testing.assert_allclose(_cat([r for _, r, _ in got]),
                               np.asarray(jsys.r0_b), rtol=0, atol=1e-12)
    assert abs(got[0][2] - float(jsys.b_norm)) <= 1e-12 * float(jsys.b_norm)


@pytest.mark.parametrize("index,name", enumerate(VCYCLE))
def test_cell_problem_vcycle_on_slabs(world, index, name):
    from openimpala_tpu.ops.stencil import (
        make_cell_problem_system as jax_system)
    from openimpala_tpu.solve.preconditioners import (
        GalerkinMGPreconditioner as JaxGMG)
    from openimpala_tpu_torch.ops.stencil import make_cell_problem_system
    from openimpala_tpu_torch.solve.preconditioners import (
        GalerkinMGPreconditioner)

    shape, dx, opts, gather = VCYCLE[name]
    active, r = _mask(4, shape), _field(6, shape)
    sys1 = make_cell_problem_system(torch.from_numpy(active), 0, dx,
                                    dtype=torch.float64)
    z1 = GalerkinMGPreconditioner.from_system(sys1, **opts)(
        torch.from_numpy(r)).numpy()
    got = world("cell_vcycle", index)
    assert [g for _, g in got] == [gather] * N
    z = _cat([z for z, _ in got])
    np.testing.assert_allclose(z, z1, rtol=0, atol=1e-10)
    jsys = jax_system(jax.numpy.asarray(active), 0, dx)
    M = JaxGMG.from_system(jsys, **opts)
    zj = np.asarray(jax.jit(lambda M_, r_: M_(r_))(M, jax.numpy.asarray(r)))
    np.testing.assert_allclose(z, zj, rtol=0, atol=1e-10)


def test_deff_integrand_sum_on_slabs(world):
    from openimpala_tpu_torch.ops.flux import deff_integrand_sum

    active = _mask(8, SUM_SHAPE)
    chis = [torch.from_numpy(_field(10 + i, SUM_SHAPE)) for i in range(3)]
    want = deff_integrand_sum(*chis, torch.from_numpy(active),
                              (1.0, 1.0, 2.0)).numpy()
    got = world("deff_sum", 0)
    for g in got:
        np.testing.assert_array_equal(g, got[0])
    np.testing.assert_allclose(got[0], want, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# effective_diffusivity under the mesh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def deff_refs():
    """The single-device port's and the JAX package's sharded and
    single-device tensors on the volume of the sharded cases."""
    from openimpala_tpu.props.effective_diffusivity import (
        effective_diffusivity as jax_deff)
    from openimpala_tpu_torch import effective_diffusivity

    phase = _vol(7, DEFF_SHAPE)
    return (effective_diffusivity(phase, 1, device="cpu", mesh=None, **KW),
            jax_deff(phase, 1, mesh=None, **KW),
            jax_deff(phase, 1, mesh=_jax_mesh(), **KW))


@pytest.mark.parametrize("index,lanes", enumerate(DEFF_LANES))
def test_effective_diffusivity_on_slabs(world, deff_refs, index, lanes):
    got = world("deff", index)
    for g in got[1:]:  # the same bits on every rank
        np.testing.assert_array_equal(g["deff"], got[0]["deff"])
        assert g["iterations"] == got[0]["iterations"]
        assert g["rel_res"] == got[0]["rel_res"]
    g = got[0]
    assert g["converged"] and g["lanes"] == (lanes is not False)
    assert g["chi_shape"] == (DEFF_SHAPE[0] // N,) + DEFF_SHAPE[1:]
    assert not g["stderr"]
    single = deff_refs[0]
    assert g["volume_fraction"] == single.volume_fraction
    for ref in deff_refs:
        scale = np.abs(np.asarray(ref.deff)).max()
        assert np.abs(g["deff"] - np.asarray(ref.deff)).max() <= 1e-6 * scale
        assert all(abs(a - int(b)) <= 2 for a, b in zip(
            g["iterations"], np.asarray(ref.iterations)))


@pytest.mark.parametrize("offset,lanes", [(0, True), (1, False)])
def test_effective_diffusivity_on_slabs_stops_at_maxiter(world, offset,
                                                         lanes):
    """The slab solves read their probe after every iteration; they stop
    at ``maxiter`` as the single-device port does, and as the JAX
    package's sequential loop does."""
    from openimpala_tpu.props.effective_diffusivity import (
        effective_diffusivity as jax_deff)
    from openimpala_tpu_torch import effective_diffusivity

    phase = _vol(7, DEFF_SHAPE)
    kw = dict(KW, maxiter=SLAB_MAXITER)
    single = effective_diffusivity(phase, 1, device="cpu", mesh=None,
                                   lanes=lanes, **kw)
    want = jax_deff(phase, 1, mesh=None, lanes=False, **kw)
    cap = (SLAB_MAXITER,) * 3
    for g in world("deff", len(DEFF_LANES) + 1 + offset):
        assert g["lanes"] == lanes and not g["converged"]
        assert g["iterations"] == single.iterations == cap
        assert tuple(want.iterations) == cap and not want.converged


def test_effective_diffusivity_of_a_host_slab(world, deff_refs):
    """A slab passed as a numpy array with its original shape gives the
    tensor slab's result bit for bit: counted over the ranks (the whole
    volume's fraction) and solved on the slab, not on a slab of it."""
    single = deff_refs[0]
    scale = np.abs(np.asarray(single.deff)).max()
    for host, dev in world("deff_slab", 0):
        np.testing.assert_array_equal(host["deff"], dev["deff"])
        assert host["iterations"] == dev["iterations"]
        assert host["volume_fraction"] == dev["volume_fraction"] \
            == single.volume_fraction
        assert np.abs(host["deff"] - single.deff).max() <= 1e-6 * scale


def test_effective_diffusivity_falls_back_where_x_does_not_divide(world):
    from openimpala_tpu.props.effective_diffusivity import (
        effective_diffusivity as jax_deff)
    from openimpala_tpu_torch import effective_diffusivity

    phase = _vol(7, FALLBACK_SHAPE)
    single = effective_diffusivity(phase, 1, device="cpu", mesh=None, **KW)
    jref = jax_deff(phase, 1, mesh=None, **KW)
    for g in world("deff", len(DEFF_LANES)):
        assert "not divisible by 4" in g["stderr"]
        assert g["chi_shape"] == FALLBACK_SHAPE  # solved whole
        np.testing.assert_array_equal(g["deff"], single.deff)
        assert g["iterations"] == tuple(single.iterations)
        scale = np.abs(np.asarray(jref.deff)).max()
        assert np.abs(g["deff"] - np.asarray(jref.deff)).max() <= 1e-6 * scale
    for msg in world("deff_padded_slab", 0):
        assert msg is not None and "not divisible by 4" in msg, msg


# ---------------------------------------------------------------------------
# the Z-page ingest and the CLI
# ---------------------------------------------------------------------------


def test_threshold_sharded_z_partition(world):
    from openimpala_tpu_torch.io import PAD_FILL, TiffReader

    tif = world.files["tif"]
    got = world("zpart", 0)
    X = TIFF_SHAPE[0]
    split = _cat([s for s, _, _, _, _ in got])
    assert split.shape == (40,) + TIFF_SHAPE[1:]
    np.testing.assert_array_equal(split, _cat([w for _, w, _, _, _ in got]))
    np.testing.assert_array_equal(split, _cat([d for _, _, d, _, _ in got]))
    np.testing.assert_array_equal(
        split[:X], TiffReader(str(world.tmp / "z.tif")).threshold(127.0))
    np.testing.assert_array_equal(split[:X], (tif > 127).astype(np.int8))
    assert (split[X:] == PAD_FILL).all()
    for _, _, _, shape, comm in got:
        assert shape == TIFF_SHAPE
        # one all-to-all of (40, 16, 4) int8: three quarters leave the rank
        assert comm["all_to_alls"] == 1
        assert comm["all_to_all_bytes"] == 40 * 16 * 4 * 3 // 4


def _tensor(out: str) -> np.ndarray:
    rows = [line.strip() for line in out.splitlines()
            if line.strip().startswith("[")]
    return np.array([[float(v) for v in r.strip("[]").split(",")]
                     for r in rows])


def _values(text: str) -> dict:
    return {k: v for k, _, v in (line.partition(": ") for line in
                                 text.splitlines() if ": " in line
                                 and not line.startswith("#"))}


@pytest.mark.parametrize("name", list(CLI_CASES))
def test_cli_on_ranks_matches_single_and_jax(world, name, capsys):
    import openimpala_tpu as oi
    from openimpala_tpu_torch import diffusion

    inputs = world.files["inputs"][name]
    assert diffusion.main([str(inputs), "device=cpu"]) == 0
    single_out = capsys.readouterr().out
    got = world("cli", list(CLI_CASES).index(name))
    assert [rc for rc, _, _, _ in got] == [0] * N
    rank0 = got[0][1]
    for _, out, txt, _ in got[1:]:  # the other ranks print and write nothing
        assert out == "" and txt is None
    for _, _, _, counts in got:  # on the CPU: no kernel, no plain on CUDA
        assert counts == {"launches": {}, "plain_on_cuda": {}}
    phase = (world.files["cli"] > 0).astype(np.int8)
    if name == "homogenization":
        # the TIFF's Z pages split over the ranks: (32, 16, 3) int8 each,
        # three quarters sent on
        assert ("Distributed ingest over 4 ranks (gloo): 1152 bytes"
                in rank0), rank0
        want = _tensor(single_out)
        assert want.shape == (3, 3)
        np.testing.assert_allclose(_tensor(rank0), want, rtol=1e-7,
                                   atol=1e-9)
        jref = np.asarray(oi.effective_diffusivity(phase, 1, mesh=None,
                                                   **KW).deff)
        np.testing.assert_allclose(_tensor(rank0), jref, rtol=1e-6,
                                   atol=1e-9)
        assert got[0][2] is None  # homogenisation writes no results.txt
        return
    single_txt = (world.tmp / "single_flow_through" / "results.txt"
                  ).read_text()
    assert got[0][2] == single_txt
    ranks = _values(got[0][2])
    for d in range(3):
        tau = float(ranks[f"Tortuosity_{'XYZ'[d]}"])
        jtau = oi.tortuosity(phase, 1, d, mesh=None, **KW).value
        assert abs(tau - jtau) <= 1e-6 * abs(jtau)
    assert re.search(r"Volume Fraction = [0-9.]+", rank0)


def _csv_rows(path):
    lines = path.read_text().splitlines()
    return lines[0], [[float(v) for v in line.split(",")]
                      for line in lines[1:]]


def test_cli_rev_study_on_ranks(world, capsys):
    """The REV study under the group: every rank solves each crop on its
    own (no mesh, though ``mesh="auto"`` would shard it), rank 0 alone
    writes the CSV and the chi plotfiles, and both equal the
    single-process CLI's (1e-6)."""
    import h5py

    from openimpala_tpu_torch import diffusion

    assert diffusion.main([str(world.files["inputs"]["rev"]),
                           "device=cpu"]) == 0
    capsys.readouterr()
    got = world("cli", len(CLI_CASES))
    assert [rc for rc, _, _, _ in got] == [0] * N
    for _, out, _, _ in got[1:]:
        assert out == ""
    single = world.tmp / "single_rev"
    ranks = [world.tmp / "ranks_rev" / f"rank{r}" for r in range(N)]
    csv = "rev_study_Deff.csv"
    head, want = _csv_rows(single / csv)
    head0, rows = _csv_rows(ranks[0] / csv)
    assert head0 == head and len(rows) == len(want) == 2
    np.testing.assert_allclose(rows, want, rtol=1e-6, atol=1e-9)
    files = sorted(p.name for p in (single / "rev_plotfiles").glob("*.h5"))
    assert len(files) == 2
    assert sorted(p.name for p in (ranks[0] / "rev_plotfiles").glob(
        "*.h5")) == files
    for name in files:
        with h5py.File(single / "rev_plotfiles" / name) as a, \
                h5py.File(ranks[0] / "rev_plotfiles" / name) as b:
            assert sorted(a) == sorted(b)
            for key in a:
                assert b[key].shape == a[key].shape == (8, 8, 8)
                np.testing.assert_allclose(b[key][()], a[key][()],
                                           rtol=0, atol=1e-6)
    for r in ranks[1:]:  # the other ranks write neither
        assert not (r / csv).exists()
        assert not (r / "rev_plotfiles").exists()


def test_lanes_gate_counts_the_ranks_on_a_device(world):
    """Four CPU ranks share one host: each holds a quarter of the volume
    in a quarter of the budget, so the gate under the mesh answers as the
    single-device gate does for the whole volume, on every rank."""
    from openimpala_tpu_torch.solve.lanes import use_lanes

    want = [use_lanes(c, 3, "cg", device="cpu") for c in GATE_CELLS]
    assert want == [True, True, False]
    for share, got in world("lanes_gate", 0):
        assert share == N
        assert got == want


def test_volume_fraction_and_ingest_rules_on_slabs(world):
    """``volume_fraction_counts`` of the padded slabs sums to the whole
    volume's counts (the padding in no phase and in no total);
    ``load_phase_sharded`` refuses an X the ranks do not divide for the
    cell problem only, and with no process group gives None."""
    from openimpala_tpu_torch import diffusion
    from openimpala_tpu_torch.config import DiffusionConfig, ParmParse

    phase = (world.files["raw"] > 127).astype(np.int8)
    for counts, loaded in world("vf_counts", 0):
        assert counts == (int((phase == 1).sum()), phase.size)
        assert loaded[0] is None  # the periodic cell problem: no padding
        assert loaded[1] == ((8,) + RAW_SHAPE[1:], RAW_SHAPE)
    cfg = DiffusionConfig.from_parmparse(ParmParse.from_file(
        str(world.tmp / "raw.inputs"), overrides=["device=cpu"]))
    assert diffusion.load_phase_sharded(cfg, allow_pad=True) is None
