"""The port's X-slab decomposition (``openimpala_tpu_torch/parallel/``) on
four ``gloo`` ranks on the CPU, held against the single-device port and
the JAX package on the same numpy inputs (the JAX side as
``tests/test_parallel.py`` runs it: ``make_mesh(n_devices=4)`` on
conftest's 8 virtual CPU devices, and the single-device call).

Every rank-side case runs in ONE world of four processes
(``parallel.spawn.World`` over ``parallel.checks.batch``), started when the
module's first test asks for it and joined with a timeout, so a deadlock
fails the tests instead of hanging the suite; the JAX references are
computed in this process while the ranks work.

Tolerances: halos and the slab stencil exact in float64; the K1 matvec
(plain form) 1e-12; one Galerkin V-cycle 1e-10, gathered at the coarsest
level or solving it on the slabs; tau 1e-6 with active_vf exact and
iterations within 2 (sums over ranks add in another order), and with the
coarsest level on the slabs 1e-12 of the gathered run with its
iterations; percolation masks and packed words bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from openimpala_tpu.ops.packfill import (
    pack_x as jax_pack_x,
    percolation_oneshot_packed_sharded as jax_packed_sharded,
)
from openimpala_tpu.parallel.halo import shard_map_stencil_apply
from openimpala_tpu.parallel.mesh import make_mesh, shard_volume
from openimpala_tpu_torch.ops.floodfill import percolation_mask
from openimpala_tpu_torch.parallel import spawn
from openimpala_tpu_torch.parallel.mesh import (
    AUTO_SHARD_MIN_CELLS,
    Mesh,
    resolve_mesh,
    shard_volume as port_shard_volume,
    slab_range,
)
from openimpala_tpu_torch.parallel.multihost import local_x_ranges

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs 4 virtual devices")

N = 4  # ranks
WORLD_TIMEOUT = 150.0  # seconds for the whole world, start-up included


def _vol(seed, shape, p=0.7):
    """A two-phase int8 volume with open lines along every axis, so that
    it percolates in X, Y and Z."""
    rng = np.random.default_rng(seed)
    phase = (rng.random(shape) < p).astype(np.int8)
    phase[:, 5, 5] = 1
    phase[5, :, 5] = 1
    phase[5, 5, :] = 1
    return phase


def _field(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape)


HALO_X = _field(1, (32, 12, 10))
MATVEC = {"iso": (32, 16, 8), "aniso": (32, 16, 8)}
MATVEC_DX = {"iso": (1.0, 1.0, 1.0), "aniso": (1.0, 1.0, 2.0)}
VCYCLE = {  # shape, dx, options; the level the slab cycle gathers at
    "even": ((32, 16, 16), (1.0, 1.0, 1.0), {}, 2),
    # X padded 30 -> 32: the original's schedule, (0,1,2) then (1,2)
    "padded": ((30, 16, 16), (1.0, 1.0, 1.0), {}, 2),
    "odd": ((36, 20, 20), (1.0, 1.0, 1.0), {}, 0),
    "semi": ((32, 16, 16), (1.0, 1.0, 2.0), {}, 2),
    "w_cheby": ((32, 16, 16), (1.0, 1.0, 1.0),
                {"cycle": "w", "smoother": "cheby"}, 2),
    "deep": ((64, 16, 16), (1.0, 1.0, 1.0), {"max_levels": 4}, 3),
}
# the flow direction of a V-cycle case (X unless named): the padded case
# flows along Y, so that its live planes are the original's system
VCYCLE_DIR = {"padded": 1}
# cases run again with the coarsest level solved on the slabs (the ranks'
# SLAB_COARSE_MIN_CELLS set to 0 for the call): a V-cycle case and how
# often a cycle visits its coarsest level, or "periodic", the periodic-X
# cell problem of X on VCYCLE["even"]'s mask; then tau cases
COARSE_MIN = {"openimpala_tpu_torch.solve.slab_mg:SLAB_COARSE_MIN_CELLS": 0}
SLAB_COARSE = {"even": 1, "semi": 1, "w_cheby": 2, "deep": 1, "periodic": 1}
TAU_SLAB_COARSE = ("x_even", "y")
TAU = {  # shape, direction, dx
    "x_even": ((32, 32, 32), 0, (1.0, 1.0, 1.0)),
    "y": ((32, 20, 20), 1, (1.0, 1.0, 1.0)),
    "z": ((32, 20, 20), 2, (1.0, 1.0, 1.0)),
    "x_odd": ((36, 20, 20), 0, (1.0, 1.0, 1.0)),
    "x_padded": ((30, 24, 20), 0, (1.0, 1.0, 1.0)),
    "x_aniso": ((32, 20, 20), 0, (1.0, 1.0, 2.0)),
}
TAU_KW = {"eps": 1e-9, "percolation_method": "host"}
# maxiter cases on slabs (after TAU's, so their indices stay): shape,
# direction, precond, a cap below what the solve needs
TAU_MAXITER = {"gmg": ((32, 20, 20), 0, "auto", 3),
               "jacobi": ((32, 20, 20), 1, "jacobi", 7)}
PERC = {  # shape, direction, original shape (the padded-outlet case)
    "x": ((256, 12, 10), 0, None),
    "y": ((256, 12, 10), 1, None),
    "z": ((256, 12, 10), 2, None),
    "x_padded": ((256, 12, 10), 0, (200, 12, 10)),
    "unsupported": ((64, 12, 10), 0, None),  # 64 % (32 * 4) != 0
}


# X of the volumes of volume_fraction_counts(local=True): slabs of 6, and
# 22 padded to 24 (the last slab holds 4 planes and 2 of PAD_FILL)
VF_LOCAL_X = (24, 22)


def _vf_volume(blob_phase, x):
    """conftest's blob volume (20 X planes) with its first planes repeated
    to ``x`` planes, as ``tests/test_props.py`` makes its X = 24 volume."""
    b = np.asarray(blob_phase, np.int8)
    return np.concatenate([b, b[:x - b.shape[0]]], axis=0)


def _perc_phase(name):
    shape, _, orig = PERC[name]
    rng = np.random.default_rng(11)
    phase = (rng.random(shape) < 0.45).astype(np.int8)
    if orig is not None:
        phase[orig[0]:] = -1  # ingest padding: in no phase
    return phase


def _mask(seed, shape):
    active = np.random.default_rng(seed).random(shape) < 0.7
    active[:, 5, 3] = True
    return active


def _files(tmp):
    """A uint8 RAW file (X, Y, Z) = (36, 16, 16) and an uncompressed TIFF
    stack (32, 16, 12), both written with numpy."""
    from openimpala_tpu_torch.io.tiff_raw import write_tiff

    rng = np.random.default_rng(5)
    raw = (rng.random((36, 16, 16)) * 255).astype(np.uint8)
    raw[:, 8, 8] = 255
    raw[18, :, 8] = 255
    raw.transpose(2, 1, 0).tofile(tmp / "v.raw")
    tif = (rng.random((32, 16, 12)) * 255).astype(np.uint8)
    tif[:, 8, 6] = 255
    tif[16, :, 6] = 255
    write_tiff(str(tmp / "v.tif"), [tif[:, :, z].T for z in range(12)])
    return raw, tif


def _jobs(tmp, blob_phase):
    jobs = [("halo", (HALO_X, False)), ("halo", (HALO_X, True))]
    for name, shape in MATVEC.items():
        jobs.append(("matvec", (_mask(2, shape), _field(3, shape), 0,
                                MATVEC_DX[name])))
    for name, (shape, dx, opts, _) in VCYCLE.items():
        jobs.append(("vcycle", (_mask(4, shape), _field(6, shape),
                                VCYCLE_DIR.get(name, 0), dx, opts)))
    for name, (shape, d, dx) in TAU.items():
        jobs.append(("tau", (_vol(7, shape), d, dict(TAU_KW, dx=dx))))
    for name, (shape, d, precond, cap) in TAU_MAXITER.items():
        jobs.append(("tau", (_vol(7, shape), d, dict(
            TAU_KW, precond=precond, maxiter=cap))))
    jobs.append(("tau_mismatch", (_vol(7, (32, 32, 32)), 0)))
    for name in SLAB_COARSE:
        shape, dx, opts, _ = VCYCLE["even" if name == "periodic" else name]
        args = (_mask(4, shape), _field(6, shape), 0, dx, opts)
        jobs.append(("with_constants", (COARSE_MIN, "vcycle", args) if
                     name != "periodic" else (COARSE_MIN, "cell_vcycle",
                                              args[:2] + args[3:])))
    for name in TAU_SLAB_COARSE:
        shape, d, dx = TAU[name]
        jobs.append(("with_constants", (COARSE_MIN, "tau", (
            _vol(7, shape), d, dict(TAU_KW, dx=dx)))))
    jobs.append(("ingest", (str(tmp / "v.raw"), "raw", (36, 16, 16), 0,
                            {"eps": 1e-9})))
    jobs.append(("ingest", (str(tmp / "v.tif"), "tiff", None, 1,
                            {"eps": 1e-9})))
    for name, (_, d, orig) in PERC.items():
        jobs.append(("percolation", (_perc_phase(name), d, orig)))
    for x in VF_LOCAL_X:
        jobs.append(("vf_local", (_vf_volume(blob_phase, x),)))
    return jobs


class _Results:
    """The world's results, keyed by case; the world runs in the
    background until a test first asks."""

    def __init__(self, tmp, blob_phase):
        self.files = _files(tmp)
        self.jobs = _jobs(tmp, blob_phase)
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
def world(tmp_path_factory, blob_phase):
    res = _Results(tmp_path_factory.mktemp("torch_parallel"), blob_phase)
    yield res
    if res._by_rank is None:  # nobody asked: still end the ranks
        res.world.wait()


def _cat(parts):
    return np.concatenate(parts, axis=0)


def _jax_mesh():
    return make_mesh(n_devices=N)


def _port_single_system(active, d, dx):
    from openimpala_tpu_torch.ops.stencil import make_tortuosity_system

    return make_tortuosity_system(torch.from_numpy(active), d, -1.0, 1.0,
                                  dx, dtype=torch.float64)


# ---------------------------------------------------------------------------
# halos
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("index,periodic_x", [(0, False), (1, True)])
def test_halo_exchange_and_slab_stencil(world, index, periodic_x):
    periodic = (periodic_x, False, False)

    def apply_padded(xp):
        return (xp[:-2, 1:-1, 1:-1] + xp[2:, 1:-1, 1:-1]
                + xp[1:-1, :-2, 1:-1] + xp[1:-1, 2:, 1:-1]
                + xp[1:-1, 1:-1, :-2] + xp[1:-1, 1:-1, 2:])

    op = shard_map_stencil_apply(apply_padded, _jax_mesh(), periodic)
    want = np.asarray(jax.jit(op)(shard_volume(jnp.asarray(HALO_X),
                                               _jax_mesh())))
    got = world("halo", index)
    xl = HALO_X.shape[0] // N
    padded = np.pad(HALO_X, ((1, 1), (0, 0), (0, 0)),
                    mode="wrap" if periodic_x else "constant")
    for r, (halo, _) in enumerate(got):
        np.testing.assert_array_equal(halo, padded[r * xl:r * xl + xl + 2])
    stencil = _cat([s for _, s in got])
    # the global neighbour sum, in the same order of additions
    full = np.pad(padded, ((0, 0), (1, 1), (1, 1)))
    np.testing.assert_array_equal(stencil, apply_padded(full))
    np.testing.assert_array_equal(stencil, want)


# ---------------------------------------------------------------------------
# operator and preconditioner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("index,name", enumerate(MATVEC))
def test_slab_matvec_matches_single_device(world, index, name):
    from openimpala_tpu.ops.stencil import (
        make_tortuosity_system as jax_system)

    shape, dx = MATVEC[name], MATVEC_DX[name]
    active, x = _mask(2, shape), _field(3, shape)
    sys1 = _port_single_system(active, 0, dx)
    out1, dot1 = sys1.apply_with_dot(torch.from_numpy(x))
    got = world("matvec", index)
    out = _cat([o for o, _, _, _ in got])
    np.testing.assert_allclose(out, out1.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(_cat([c for _, _, c, _ in got]),
                                  sys1.code.float().numpy())
    for _, dot, _, b_norm in got:
        assert dot == got[0][1]  # the same bits on every rank
        assert abs(dot - float(dot1)) <= 1e-12 * abs(float(dot1))
        assert b_norm == pytest.approx(float(sys1.b_norm), rel=1e-15)
    jsys = jax_system(jnp.asarray(active), 0, -1.0, 1.0, dx)
    np.testing.assert_allclose(out, np.asarray(jsys.apply(jnp.asarray(x))),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("index,name", enumerate(VCYCLE))
def test_slab_vcycle_matches_single_device(world, index, name):
    from openimpala_tpu.ops.stencil import (
        make_tortuosity_system as jax_system)
    from openimpala_tpu.solve.preconditioners import (
        GalerkinMGPreconditioner as JaxGMG)
    from openimpala_tpu_torch.solve.preconditioners import (
        GalerkinMGPreconditioner)

    shape, dx, opts, gather = VCYCLE[name]
    d = VCYCLE_DIR.get(name, 0)
    active, r = _mask(4, shape), _field(6, shape)
    sys1 = _port_single_system(active, d, dx)
    r = np.where(sys1.free.numpy(), r, 0.0)
    z1 = GalerkinMGPreconditioner.from_system(sys1, **opts)(
        torch.from_numpy(r)).numpy()
    got = world("vcycle", index)
    assert [g for _, g in got] == [gather] * N
    z = _cat([z for z, _ in got])
    X = shape[0]
    assert not z[X:].any()  # the padded planes are inactive
    z = z[:X]
    np.testing.assert_allclose(z, z1, rtol=0, atol=1e-10)
    jsys = jax_system(jnp.asarray(active), d, -1.0, 1.0, dx)
    M = JaxGMG.from_system(jsys, **opts)
    zj = np.asarray(jax.jit(lambda M_, r_: M_(r_))(M, jnp.asarray(r)))
    np.testing.assert_allclose(z, zj, rtol=0, atol=1e-10)


@pytest.mark.parametrize("index,name", enumerate(SLAB_COARSE))
def test_slab_vcycle_coarsest_on_slabs(world, index, name):
    """With the coarsest level's Chebyshev solve on the slabs (K2's cheby
    step on each padded slab, one ghost exchange a step) the cycle equals
    the single-device cycle and the JAX package's to 1e-10, clamped and
    periodic in X, and each visit of the coarsest level makes
    ``coarse_sweeps - 1`` exchanges there."""
    from openimpala_tpu.ops import stencil as jax_stencil
    from openimpala_tpu.solve.preconditioners import (
        GalerkinMGPreconditioner as JaxGMG)
    from openimpala_tpu_torch.ops.stencil import make_cell_problem_system
    from openimpala_tpu_torch.solve.preconditioners import (
        GalerkinMGPreconditioner)

    shape, dx, opts, _ = VCYCLE["even" if name == "periodic" else name]
    active, r = _mask(4, shape), _field(6, shape)
    if name == "periodic":
        sys1 = make_cell_problem_system(torch.from_numpy(active), 0, dx,
                                        dtype=torch.float64)
        jsys = jax_stencil.make_cell_problem_system(jnp.asarray(active), 0,
                                                    dx)
    else:
        sys1 = _port_single_system(active, 0, dx)
        r = np.where(sys1.free.numpy(), r, 0.0)
        jsys = jax_stencil.make_tortuosity_system(jnp.asarray(active), 0,
                                                  -1.0, 1.0, dx)
    M1 = GalerkinMGPreconditioner.from_system(sys1, **opts)
    z1 = M1(torch.from_numpy(r)).numpy()
    got = world("with_constants", index)
    assert [g for (_, g), _ in got] == [None] * N
    for _, counts in got:
        assert counts["mesh"]["coarse_slab_exchanges"] == (
            SLAB_COARSE[name] * (M1.coarse_sweeps - 1))
    z = _cat([z for (z, _), _ in got])
    np.testing.assert_allclose(z, z1, rtol=0, atol=1e-10)
    M = JaxGMG.from_system(jsys, **opts)
    zj = np.asarray(jax.jit(lambda M_, r_: M_(r_))(M, jnp.asarray(r)))
    np.testing.assert_allclose(z, zj, rtol=0, atol=1e-10)


def test_slab_coarse_rule():
    """The coarsest level goes on the slabs only where every coarsening
    is rank-local, the coarse solve is Chebyshev's and the global level
    has ``SLAB_COARSE_MIN_CELLS`` cells; VCYCLE's volumes lie below it, so
    their gather levels are the ones ``test_slab_vcycle_matches_single_
    device`` holds, and 1024^3's coarsest (256^3) lies above it."""
    from openimpala_tpu_torch.solve.preconditioners import (
        GalerkinMGPreconditioner)
    from openimpala_tpu_torch.solve.slab_mg import (
        SLAB_COARSE_MIN_CELLS as MIN, coarse_on_slabs)

    full = ((0, 1, 2), (0, 1, 2))
    assert coarse_on_slabs(2, full, 256 ** 3)
    assert coarse_on_slabs(2, full, MIN)
    assert not coarse_on_slabs(2, full, MIN - 1)
    assert not coarse_on_slabs(1, full, MIN)  # gathered above the coarsest
    assert not coarse_on_slabs(0, (), MIN)  # no coarse level at all
    assert not coarse_on_slabs(2, full, MIN, coarse_solver="jacobi")
    for shape, dx, opts, gather in VCYCLE.values():
        w = tuple(1.0 / d ** 2 for d in dx)
        coarsest = list(shape)
        for axes in GalerkinMGPreconditioner._schedule_for(
                shape, w, opts.get("max_levels", 3)):
            for a in axes:
                coarsest[a] //= 2
        assert np.prod(coarsest) < MIN and gather is not None


@pytest.mark.parametrize("index,name", enumerate(TAU_SLAB_COARSE))
def test_tortuosity_coarsest_on_slabs(world, index, name):
    """tau with the coarsest level's solve on the slabs: the iterations of
    the gathered run and its tau within 1e-12, the same on every rank."""
    got = world("with_constants", len(SLAB_COARSE) + index)
    gathered = world("tau", list(TAU).index(name))[0]
    for g, counts in got:
        assert g == got[0][0]
        assert g["converged"] and g["iterations"] == gathered["iterations"]
        assert abs(g["value"] - gathered["value"]) <= 1e-12
        assert counts["mesh"]["coarse_slab_exchanges"] > 0


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def test_shard_volume_divisibility_and_resolve():
    mesh = Mesh(group=None, size=4, rank=1, device=torch.device("cpu"),
                backend="gloo")
    with pytest.raises(ValueError, match="not divisible"):
        port_shard_volume(np.zeros((30, 4, 4)), mesh)
    x = np.arange(32 * 2 * 2).reshape(32, 2, 2)
    np.testing.assert_array_equal(port_shard_volume(x, mesh), x[8:16])
    # no process group: "auto" is one rank, whatever the size
    big = (AUTO_SHARD_MIN_CELLS, 1, 1)
    assert resolve_mesh("auto", big) is None
    assert resolve_mesh(None, big) is None
    assert resolve_mesh(mesh, big) is mesh
    with pytest.raises(ValueError):
        resolve_mesh("all", big)
    # the planes of the original X a rank reads: 30 over 4 ranks pads to
    # 32, slabs of 8; the last rank holds 6 real planes
    assert slab_range(mesh, 30) == (8, 16)
    last = Mesh(group=None, size=4, rank=3, device=torch.device("cpu"),
                backend="gloo")
    assert local_x_ranges(last, 30) == [(24, 30)]
    assert local_x_ranges(last, 5) == []  # 5 -> 8: the last slab is padding


def test_pad_volume_to_and_upload_mask_match_jax():
    from openimpala_tpu.ops.masks import pad_volume_to as jax_pad
    from openimpala_tpu_torch.ops.masks import pad_volume_to, upload_mask

    vol = _vol(10, (30, 8, 6))
    np.testing.assert_array_equal(pad_volume_to(vol, 8, -1),
                                  jax_pad(vol, 8, -1))
    assert pad_volume_to(vol, 5) is vol  # already divisible
    mask = vol == 1
    mesh = Mesh(group=None, size=4, rank=3, device=torch.device("cpu"),
                backend="gloo")
    padded = jax_pad(mask, 4, False)  # 30 -> 32: slabs of 8
    for m in (mask, torch.from_numpy(mask)):
        slab = upload_mask(m, mesh)
        assert slab.dtype == torch.bool
        np.testing.assert_array_equal(slab.numpy(), padded[24:32])
    np.testing.assert_array_equal(upload_mask(mask, device="cpu").numpy(),
                                  mask)
    if not torch.cuda.is_available():  # None means CUDA: no quiet CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            upload_mask(mask)


def test_count_true_any_true_match_jax():
    from openimpala_tpu.utils.common import any_true as jax_any
    from openimpala_tpu.utils.common import count_true as jax_count
    from openimpala_tpu_torch.utils.common import any_true, count_true

    for m in (_mask(9, (8, 6, 4)), np.zeros((3, 2, 2), bool)):
        assert count_true(torch.from_numpy(m)) == jax_count(jnp.asarray(m))
        assert any_true(torch.from_numpy(m)) == jax_any(jnp.asarray(m))


# ---------------------------------------------------------------------------
# tortuosity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("index,name", enumerate(TAU))
def test_tortuosity_on_slabs_matches_single_and_jax(world, index, name):
    from openimpala_tpu.props.tortuosity import tortuosity as jax_tau
    from openimpala_tpu_torch import tortuosity

    shape, d, dx = TAU[name]
    phase = _vol(7, shape)
    single = tortuosity(phase, 1, d, device="cpu", mesh=None, dx=dx,
                        **TAU_KW)
    j_single = jax_tau(phase, 1, d, mesh=None, dx=dx, **TAU_KW)
    j_sharded = jax_tau(phase, 1, d, mesh=_jax_mesh(), dx=dx, **TAU_KW)
    got = world("tau", index)
    for g in got[1:]:
        assert g == got[0]  # the same result on every rank
    g = got[0]
    assert g["converged"] and g["flux_conserved"]
    for ref in (single, j_single, j_sharded):
        assert abs(g["value"] - ref.value) <= 1e-6, (name, g, ref)
        assert g["active_vf"] == ref.active_vf
        assert abs(g["iterations"] - ref.iterations) <= 2


@pytest.mark.parametrize("index,name", enumerate(TAU_MAXITER))
def test_tortuosity_on_slabs_stops_at_maxiter(world, index, name):
    """The slab solve reads its probe after every iteration; it stops at
    ``maxiter`` as the single-device port and the JAX package do."""
    from openimpala_tpu.props.tortuosity import tortuosity as jax_tau
    from openimpala_tpu_torch import tortuosity

    shape, d, precond, cap = TAU_MAXITER[name]
    kw = dict(TAU_KW, precond=precond, maxiter=cap)
    phase = _vol(7, shape)
    single = tortuosity(phase, 1, d, device="cpu", mesh=None, **kw)
    want = jax_tau(phase, 1, d, mesh=None, **kw)
    for g in world("tau", len(TAU) + index):
        assert g["iterations"] == single.iterations == want.iterations == cap
        assert not g["converged"] and not want.converged
        assert np.isnan(g["value"]) and np.isnan(want.value)


def test_tortuosity_on_slabs_refuses_different_volumes(world):
    """Ranks that pass different volumes under a mesh all raise, instead
    of summing their slabs of different volumes."""
    got = world("tau_mismatch", 0)
    for msg in got:
        assert msg is not None and "rank(s) [1]" in msg, msg


@pytest.mark.parametrize("index,kind", [(0, "raw"), (1, "tiff")])
def test_threshold_sharded_into_tortuosity(world, index, kind):
    from openimpala_tpu_torch import tortuosity
    from openimpala_tpu_torch.io import PAD_FILL

    vol = world.files[index]
    direction = 0 if kind == "raw" else 1
    want = (vol > 127).astype(np.int8)
    got = world("ingest", index)
    slab = _cat([s for s, _, _ in got])
    X = vol.shape[0]
    assert got[0][1] == vol.shape
    assert slab.shape[0] == X + (-X) % N
    np.testing.assert_array_equal(slab[:X], want)
    assert (slab[X:] == PAD_FILL).all()
    ref = tortuosity(want, 1, direction, device="cpu", mesh=None, eps=1e-9)
    for _, _, g in got:
        assert g == got[0][2]
    g = got[0][2]
    assert g["converged"] and g["flux_conserved"]
    assert g["active_vf"] == ref.active_vf
    assert abs(g["value"] - ref.value) <= 1e-6
    assert abs(g["iterations"] - ref.iterations) <= 2
    # the padded X slab (36 -> 40) is not a multiple of 32 x 4: the native
    # BFS with plane exchanges made the mask
    assert g["percolation_method"] == "native"


# ---------------------------------------------------------------------------
# percolation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("index,name", enumerate(PERC))
def test_sharded_percolation_bit_for_bit(world, index, name):
    shape, d, orig = PERC[name]
    phase = _perc_phase(name)
    core = phase[:orig[0]] if orig else phase
    host, vf = percolation_mask(core, 1, d, method="host", device="cpu")
    want = np.zeros(shape, bool)
    want[:core.shape[0]] = host
    got = world("percolation", index)
    np.testing.assert_array_equal(_cat([a for _, a, _, _ in got]), want)
    for _, _, v, counted in got:
        assert v == int(host.sum()) / float(np.prod(orig or shape))
        assert counted == (int(host.sum()), bool(host.any()))
    jok = shard_volume(jnp.asarray(phase == 1), _jax_mesh())
    jres = jax_packed_sharded(
        jok, d, outlet=(orig or shape)[d] - 1 if orig else None)
    packed = [p for p, _, _, _ in got]
    if name == "unsupported":
        assert jres is None and packed == [None] * N
        return
    words = _cat([w for w, _ in packed]).view(np.uint32)
    jactive, jcounts = jres
    np.testing.assert_array_equal(words, np.asarray(jax_pack_x(jactive)))
    np.testing.assert_array_equal(words, np.asarray(
        jax_pack_x(jnp.asarray(want))))
    np.testing.assert_array_equal(_cat([c for _, c in packed]),
                                  np.asarray(jcounts))


# ---------------------------------------------------------------------------
# volume_fraction_counts(local=True) and prime_solver(mesh=)
# ---------------------------------------------------------------------------


def test_local_volume_fraction_counts_are_jax_shard_entries(world,
                                                            blob_phase):
    """X = 24: each rank's own pair is entry ``rank`` of the JAX package's
    per-shard lists (``tests/test_props.py``'s rule, on 4 devices), and
    the pairs sum to the mesh-reduced pair."""
    from openimpala_tpu.props.volume_fraction import (
        volume_fraction_counts as jax_counts)

    vol = _vf_volume(blob_phase, 24)
    counts, totals = jax_counts(shard_volume(jnp.asarray(vol), _jax_mesh()),
                                1, local=True)
    got = world("vf_local", 0)
    assert [pair for pair, _ in got] == list(zip(counts, totals))
    whole = (int((vol == 1).sum()), vol.size)
    assert [reduced for _, reduced in got] == [whole] * N
    assert sum(totals) == vol.size


def test_local_volume_fraction_counts_leave_out_the_padding(world,
                                                            blob_phase):
    """X = 22, padded to 24 with ``PAD_FILL``: the ranks' pairs sum to
    the whole volume's, the padded planes in neither count."""
    vol = _vf_volume(blob_phase, 22)
    got = world("vf_local", 1)
    whole = (int((vol == 1).sum()), vol.size)
    pairs = [pair for pair, _ in got]
    assert tuple(map(sum, zip(*pairs))) == whole
    assert pairs[-1][1] == 4 * vol.shape[1] * vol.shape[2]
    assert [reduced for _, reduced in got] == [whole] * N


def test_prime_solver_takes_the_jax_cli_call_shape():
    """The keywords ``openimpala_tpu/diffusion.py`` passes, and
    ``mesh="auto"``: None off CUDA, as the JAX package's is off the TPU."""
    from openimpala_tpu.props.tortuosity import prime_solver as jax_prime
    from openimpala_tpu_torch.props.tortuosity import prime_solver

    kw = dict(vlo=0.0, vhi=1.0, method="cg", precond="auto",
              inner_dtype=torch.float32, eps=1e-9, dx=(1.0, 1.0, 2.0),
              extra_dirs=(1, 2), mesh="auto")
    assert prime_solver((64, 48, 32), 0, device="cpu", **kw) is None
    if not torch.cuda.is_available():
        assert prime_solver((64, 48, 32), "X", **kw) is None
    jkw = dict(kw, inner_dtype=jnp.float32)
    assert jax_prime((64, 48, 32), 0, **jkw) is None


def test_spawn_runs_on_the_card_unless_asked(tmp_path):
    """``spawn.run``'s ranks take the port's device rule: with no
    ``device``, CUDA, which raises where there is no card."""
    if torch.cuda.is_available():
        assert spawn.run("openimpala_tpu_torch.parallel.checks:batch", 2,
                         args=([],), timeout=60, workdir=tmp_path,
                         threads=1) == [[], []]
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spawn.run("openimpala_tpu_torch.parallel.checks:batch", 2,
                  args=([],), timeout=60, workdir=tmp_path, threads=1)


def test_a_failing_rank_fails_the_world(tmp_path):
    """A rank's exception reaches the caller with its traceback, and no
    rank is left running."""
    with pytest.raises(RuntimeError, match="KeyError"):
        spawn.run("openimpala_tpu_torch.parallel.checks:batch", 2,
                  args=([("no_such_check", ())],), device="cpu", timeout=60,
                  workdir=tmp_path, threads=1)
