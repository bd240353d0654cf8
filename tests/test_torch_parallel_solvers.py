"""Every preconditioner and Krylov method on X slabs (``openimpala_tpu_torch``:
``precond="sa"`` with K3 on two-plane halos, ``"mg"``, ``"cheby"`` with K5
on padded slabs, FGMRES) under ``tortuosity``, ``effective_diffusivity``
and the distributed CLI, on four ``gloo`` ranks on the CPU, held against
the single-device port and the JAX package on the same numpy inputs (the
JAX side as ``tests/test_parallel.py`` runs it: ``make_mesh(n_devices=4)``
on conftest's virtual CPU devices, and the single-device call).

Every rank-side case runs in ONE world of four processes of its own
(``parallel.spawn.World`` over ``parallel.checks.batch``), started when the
module's first test asks for it and joined with a timeout; the references
are computed in this process meanwhile (the first tests ask for the world
before their reference fixtures).

Tolerances: each rank's smoothed-aggregation levels keep the single-device
port's offsets (and the JAX package's) and the rank's slab of every
sharded level's coefficients is within 1e-12 of one card's; one
application of each slab preconditioner (sa, mg, cheby) 1e-10 of one
card's; tau and D 1e-6 of the JAX package's sharded and single-device
results and of the port's one card, the same bits on every rank;
iterations (FGMRES: Arnoldi steps) within 2 of the port's one card, and
of the JAX package's for the CG paths (its FGMRES counts steps in its own
fused loop, where its sharded and single-device runs differ by up to 8);
the CLI's tau 1e-6 of the single-process CLI's and of the JAX package's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from openimpala_tpu.parallel.mesh import make_mesh
from openimpala_tpu_torch.parallel import spawn

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs 4 virtual devices")

N = 4  # ranks
WORLD_TIMEOUT = 300.0  # seconds for the whole world, start-up included
KW = {"eps": 1e-9}
TAU_KW = dict(KW, percolation_method="host")


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


ISO = (1.0, 1.0, 1.0)
# the smoothed-aggregation hierarchy on the slabs: shape, system, cycle
# options, and the level it gathers at
SA_LEVELS = {
    "flow": ((32, 16, 16), "flow", {}, 2),
    # periodic: K3's halo carries the wrap from the last rank to rank 0
    "cell_w": ((32, 16, 16), "cell", {"cycle": "w"}, 2),
    # level 2 holds one plane per rank, less than its reach: gathered
    "one_plane": ((16, 32, 32), "flow", {}, 2),
    # level 1 slabs of 3 planes: their block sums cannot pair
    "odd_level1": ((24, 16, 16), "flow", {}, 1),
    # fine slabs of 9 planes: the whole hierarchy built on every rank
    "odd_fine": ((36, 16, 16), "flow", {}, 0),
}
# one application of the slab "mg" and "cheby" forms (the mg cycle
# gathers at its coarsest level, 2; cheby has no levels)
APPLY_SHAPE = (32, 16, 16)
APPLY = [(kind, precond) for kind in ("flow", "cell")
         for precond in ("mg", "cheby")]
TAU_SHAPE = (32, 20, 20)
PADDED_SHAPE = (30, 24, 20)  # X padded to 32: 8-plane slabs
TAU = {
    "sa": (TAU_SHAPE, {"precond": "sa"}),
    "mg": (TAU_SHAPE, {"precond": "mg"}),
    "cheby": (TAU_SHAPE, {"precond": "cheby"}),
    "fgmres": (TAU_SHAPE, {"method": "fgmres"}),
    "fgmres_sa": (TAU_SHAPE, {"method": "fgmres", "precond": "sa"}),
    # the original's depth (one level: 15 does not coarsen), padded planes
    # dead cells of it
    "padded_sa": (PADDED_SHAPE, {"precond": "sa"}),
    "padded_mg": (PADDED_SHAPE, {"precond": "mg"}),
}
# level 1 (16 x 6 x 6) is the coarsest: the sharded fine level carries the
# wrap (K1 in the smoothed transfers), the gathered level runs on every
# rank; the periodic K3 halo is ``SA_LEVELS["cell_w"]``'s
DEFF_SHAPE = (32, 12, 12)
DEFF = {"sa": {"precond": "sa", "lanes": False},
        "cheby": {"precond": "cheby", "lanes": False},
        "sa_lanes": {"precond": "sa", "lanes": True}}
CLI_SHAPE = (32, 16, 12)


def _write_tiff(path, vol):
    from openimpala_tpu_torch.io.tiff_raw import write_tiff

    write_tiff(str(path), [vol[:, :, z].T for z in range(vol.shape[2])])


def _files(tmp):
    cli = _vol(9, CLI_SHAPE, p=0.6).astype(np.uint8) * 200
    _write_tiff(tmp / "cli.tif", cli)
    inputs = tmp / "gmres_sa.inputs"
    inputs.write_text("\n".join([
        "filename = cli.tif", f"data_path = {tmp}/",
        f"results_path = {tmp}/single/", "phase_id = 1",
        "calculation_method = flow_through", "direction = X",
        "solver_type = GMRES", "solver.precond = sa", "hypre.eps = 1e-9",
        "verbose = 1"]) + "\n")
    return {"cli": cli, "inputs": inputs}


def _jobs(tmp, files):
    jobs = []
    for shape, kind, opts, _ in SA_LEVELS.values():
        jobs.append(("sa_levels", (_mask(4, shape), _field(6, shape), kind,
                                   0, ISO, opts)))
    for kind, precond in APPLY:
        jobs.append(("precond_apply", (_mask(4, APPLY_SHAPE),
                                       _field(6, APPLY_SHAPE), kind, 0, ISO,
                                       precond, {})))
    for shape, kw in TAU.values():
        jobs.append(("tau", (_vol(3, shape), 0, dict(TAU_KW, **kw))))
    for kw in DEFF.values():
        jobs.append(("deff", (_vol(7, DEFF_SHAPE), dict(KW, **kw))))
    jobs.append(("cli", (str(files["inputs"]), str(tmp / "ranks"))))
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
    res = _Results(tmp_path_factory.mktemp("torch_parallel_solvers"))
    yield res
    if res._by_rank is None:  # nobody asked: still end the ranks
        res.world.wait()


def _cat(parts):
    return np.concatenate(parts, axis=0)


def _port_system(active, kind):
    from openimpala_tpu_torch.ops.stencil import (
        make_cell_problem_system, make_tortuosity_system)

    a = torch.from_numpy(active)
    if kind == "cell":
        return make_cell_problem_system(a, 0, ISO, dtype=torch.float64)
    return make_tortuosity_system(a, 0, -1.0, 1.0, ISO, dtype=torch.float64)


def _jax_system(active, kind):
    from openimpala_tpu.ops import stencil as JS

    a = jnp.asarray(active)
    if kind == "cell":
        return JS.make_cell_problem_system(a, 0, dtype=jnp.float64)
    return JS.make_tortuosity_system(a, 0, -1.0, 1.0, dtype=jnp.float64)


# ---------------------------------------------------------------------------
# tortuosity, effective_diffusivity and the CLI with them
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tau_refs():
    """name -> (the port's one card, [JAX results], whether the JAX
    iterations are held): the JAX package's single-device call with the
    same solver and its sharded one (for "sa" the JAX sharded SA, the
    default cycle's sharded and single-device results beside it)."""
    import openimpala_tpu as oi
    from openimpala_tpu_torch import tortuosity

    mesh = make_mesh(n_devices=N)
    base = {s: [oi.tortuosity(_vol(3, s), 1, 0, mesh=m, **TAU_KW)
                for m in (None, mesh)] for s in (TAU_SHAPE, PADDED_SHAPE)}
    jsa = oi.tortuosity(_vol(3, TAU_SHAPE), 1, 0, mesh=mesh,
                        precond="sa", **TAU_KW)
    out = {}
    for name, (shape, kw) in TAU.items():
        phase = _vol(3, shape)
        one = tortuosity(phase, 1, 0, device="cpu", mesh=None,
                         **dict(TAU_KW, **kw))
        if name in ("mg", "cheby", "fgmres"):
            jax_refs = [oi.tortuosity(phase, 1, 0, mesh=m,
                                      **dict(TAU_KW, **kw))
                        for m in (None, mesh)]
        elif name == "sa":
            jax_refs = [jsa]
        else:
            jax_refs = []
        out[name] = (one, jax_refs + base[shape], len(jax_refs))
    return out


@pytest.mark.parametrize("index,name", enumerate(TAU))
def test_tortuosity_on_slabs(world, tau_refs, index, name):
    one, jax_refs, n_same = tau_refs[name]
    got = world("tau", index)
    for g in got[1:]:  # the same bits on every rank
        assert g == got[0]
    g = got[0]
    assert g["converged"] and g["flux_conserved"] and one.converged
    assert g["active_vf"] == one.active_vf
    assert abs(g["iterations"] - one.iterations) <= 2
    for ref in [one] + jax_refs:
        assert abs(g["value"] - ref.value) <= 1e-6 * abs(ref.value)
    if "fgmres" not in name:  # the same solver's JAX iterations
        for ref in jax_refs[:n_same]:
            assert abs(g["iterations"] - int(ref.iterations)) <= 2


@pytest.fixture(scope="module")
def deff_refs():
    """The port's one card per case (the sequential SA solve for the SA
    lanes too), and the JAX package's single-device and sharded tensors
    with the Chebyshev polynomial (the JAX SA cell problems take half a
    minute each on this CPU; every solver converges the same tensor to
    1e-9)."""
    import openimpala_tpu as oi
    from openimpala_tpu_torch import effective_diffusivity

    phase = _vol(7, DEFF_SHAPE)
    ones = {name: effective_diffusivity(phase, 1, device="cpu", mesh=None,
                                        **dict(KW, **kw))
            for name, kw in DEFF.items() if name != "sa_lanes"}
    ones["sa_lanes"] = ones["sa"]
    jax_refs = [oi.effective_diffusivity(phase, 1, mesh=m, precond="cheby",
                                         **KW)
                for m in (None, make_mesh(n_devices=N))]
    return ones, jax_refs


@pytest.mark.parametrize("index,name", enumerate(DEFF))
def test_effective_diffusivity_on_slabs(world, deff_refs, index, name):
    ones, jax_refs = deff_refs
    one = ones[name]
    got = world("deff", index)
    for g in got[1:]:  # the same bits on every rank
        np.testing.assert_array_equal(g["deff"], got[0]["deff"])
        assert g["iterations"] == got[0]["iterations"]
        assert g["rel_res"] == got[0]["rel_res"]
    g = got[0]
    assert g["converged"] and not g["stderr"]
    assert g["lanes"] == DEFF[name]["lanes"]
    assert g["chi_shape"] == (DEFF_SHAPE[0] // N,) + DEFF_SHAPE[1:]
    assert all(abs(a - b) <= 2 for a, b in zip(g["iterations"],
                                               one.iterations))
    for ref in [one] + jax_refs:
        d = np.asarray(ref.deff)
        assert np.abs(g["deff"] - d).max() <= 1e-6 * np.abs(d).max()
    if name == "cheby":
        for ref in jax_refs:
            assert all(abs(a - int(b)) <= 2 for a, b in zip(
                g["iterations"], np.asarray(ref.iterations)))


def _values(text: str) -> dict:
    return {k: v for k, _, v in (line.partition(": ") for line in
                                 text.splitlines() if ": " in line
                                 and not line.startswith("#"))}


def test_cli_gmres_sa_on_ranks(world, capsys):
    """``solver_type = GMRES`` with ``solver.precond = sa`` under the
    group: rank 0 alone prints and writes, its tau within 1e-6 of the
    single-process CLI's and of the JAX package's."""
    import openimpala_tpu as oi
    from openimpala_tpu_torch import diffusion

    assert diffusion.main([str(world.files["inputs"]), "device=cpu"]) == 0
    capsys.readouterr()
    single = _values((world.tmp / "single" / "results.txt").read_text())
    got = world("cli", 0)
    assert [rc for rc, _, _, _ in got] == [0] * N
    assert "Distributed ingest over 4 ranks (gloo)" in got[0][1]
    for _, out, txt, _ in got[1:]:  # the other ranks print and write nothing
        assert out == "" and txt is None
    for _, _, _, counts in got:  # on the CPU: no kernel, no plain on CUDA
        assert counts == {"launches": {}, "plain_on_cuda": {}}
    ranks = _values(got[0][2])
    assert ranks["VolumeFraction"] == single["VolumeFraction"]
    tau = float(ranks["Tortuosity_X"])
    phase = (world.files["cli"] > 0).astype(np.int8)
    jtau = oi.tortuosity(phase, 1, 0, mesh=None, **KW).value
    for ref in (float(single["Tortuosity_X"]), jtau):
        assert abs(tau - ref) <= 1e-6 * abs(ref)


# ---------------------------------------------------------------------------
# the slab forms: the probed hierarchy, one application of each
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("index,name", enumerate(SA_LEVELS))
def test_sa_hierarchy_on_slabs(world, index, name):
    from openimpala_tpu_torch.solve.sa import SAMGPreconditioner

    shape, kind, opts, gather = SA_LEVELS[name]
    active, r = _mask(4, shape), _field(6, shape)
    M1 = SAMGPreconditioner.from_system(_port_system(active, kind), **opts)
    got = world("sa_levels", index)
    assert [g for g, _, _, _ in got] == [gather] * N
    n_sharded = max(0, gather - 1)
    for li, lvl in enumerate(M1.levels):
        if li < n_sharded:  # the rank's slab of the level, halo width R
            for _, sharded, _, _ in got:
                offsets, width, _ = sharded[li]
                assert offsets == lvl.offsets
                assert width == max(abs(o[0]) for o in lvl.offsets) == 2
            packed = _cat([sharded[li][2] for _, sharded, _, _ in got])
        else:  # gathered: every rank holds the whole level
            for _, _, glob, _ in got:
                assert glob[li - n_sharded][0] == lvl.offsets
                np.testing.assert_array_equal(glob[li - n_sharded][1],
                                              got[0][2][li - n_sharded][1])
            packed = got[0][2][li - n_sharded][1]
        np.testing.assert_allclose(packed, lvl.packed.numpy(), rtol=0,
                                   atol=1e-12)
    z1 = M1(torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(_cat([z for _, _, _, z in got]), z1, rtol=0,
                               atol=1e-10)
    if name == "flow":  # the JAX package's probed offsets
        from openimpala_tpu.solve.sa import SAMGPreconditioner as JaxSA

        MJ = JaxSA.from_system(_jax_system(active, kind))
        assert [l.offsets for l in MJ.levels] == [l.offsets
                                                  for l in M1.levels]


@pytest.mark.parametrize("index,case", enumerate(APPLY))
def test_mg_and_cheby_application_on_slabs(world, index, case):
    from openimpala_tpu_torch.solve.refine import make_precond

    kind, precond = case
    active, r = _mask(4, APPLY_SHAPE), _field(6, APPLY_SHAPE)
    z1 = make_precond(_port_system(active, kind), precond)(
        torch.from_numpy(r)).numpy()
    got = world("precond_apply", index)
    assert [g for _, g in got] == [2 if precond == "mg" else None] * N
    np.testing.assert_allclose(_cat([z for z, _ in got]), z1, rtol=0,
                               atol=1e-10)


# ---------------------------------------------------------------------------
# the rules and the halo, in this process
# ---------------------------------------------------------------------------


def test_sa_level_stays_sharded_rule():
    from openimpala_tpu_torch.solve.slab_sa import stays_sharded

    assert stays_sharded(1, 3, 2, 2)
    assert not stays_sharded(1, 3, 1, 2)  # one plane, reach 2: gathered
    assert stays_sharded(2, 3, 2, 1)
    assert not stays_sharded(1, 3, 3, 2)  # odd: the block sums cannot pair
    assert not stays_sharded(3, 3, 4, 2)  # the coarsest is gathered
    assert stays_sharded(1, 2, 2, 0)  # a level without X taps


@pytest.mark.parametrize("periodic", [False, True])
def test_two_plane_halo_without_a_mesh(periodic):
    from openimpala_tpu_torch.parallel.halo import halo_exchange_x

    x = torch.arange(5 * 2 * 3, dtype=torch.float64).reshape(5, 2, 3)
    xp = halo_exchange_x(x, periodic, None, width=2)
    assert xp.shape == (9, 2, 3)
    np.testing.assert_array_equal(xp[2:7].numpy(), x.numpy())
    if periodic:  # the slab's own wrap, two planes deep
        np.testing.assert_array_equal(xp[:2].numpy(), x[3:].numpy())
        np.testing.assert_array_equal(xp[7:].numpy(), x[:2].numpy())
    else:
        assert not xp[:2].any() and not xp[7:].any()
    with pytest.raises(ValueError, match="cannot fill a halo"):
        halo_exchange_x(x[:1], periodic, None, width=2)
