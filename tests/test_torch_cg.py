"""PyTorch port, ``solve/cg.py`` and ``solve/refine.py``: the chunked
top-form PCG on a system and preconditioner carried across from JAX
against JAX's ``_cg_chunked_loop`` on the same inputs in float64 — the same
recurrence, so the iteration count is equal — and the refinement driver."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import importlib  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from openimpala_tpu.ops import masks as JM  # noqa: E402
from openimpala_tpu.ops import stencil as JS  # noqa: E402
from openimpala_tpu.solve import preconditioners as JP  # noqa: E402
from openimpala_tpu_torch import convert  # noqa: E402
from openimpala_tpu_torch.ops import stencil as PS  # noqa: E402
from openimpala_tpu_torch.solve import cg as PC  # noqa: E402
from openimpala_tpu_torch.solve import preconditioners as PP  # noqa: E402
from openimpala_tpu_torch.solve import refine as PR  # noqa: E402

# the JAX package's solve/__init__ re-exports functions under these names
JC = importlib.import_module("openimpala_tpu.solve.cg")
JR = importlib.import_module("openimpala_tpu.solve.refine")


def _jax_problem(shape, dx, seed=0, precond=True):
    mask = np.random.default_rng(seed).random(shape) < 0.75
    js = JS.make_tortuosity_system(jnp.asarray(mask), 0, -1.0, 1.0, dx=dx)
    ramp = JM.linear_ramp(shape, 0, -1.0, 1.0)
    x0 = jnp.where(js.free, ramp, 0.0)
    r0 = js.initial_residual(x0)
    jm = JP.GalerkinMGPreconditioner.from_system(js) if precond else None
    return mask, js, x0, r0, jm


def _carry(js, jm):
    ps = convert.system_from_numpy(
        np.asarray(js.code), np.asarray(js.x_forced), np.asarray(js.r0_b),
        np.asarray(js.b_norm), js.w, js.periodic, device="cpu")
    if jm is None:
        return ps, None
    levels = tuple(
        convert.conductance_level_from_numpy(
            *(np.asarray(getattr(lv, n)) for n in ("diag", "cx", "cy", "cz")),
            device="cpu")
        for lv in jm.levels)
    pm = PP.GalerkinMGPreconditioner(
        fine=PP.MGLevel(code=ps.code, w=ps.w, periodic=ps.periodic),
        levels=levels, coarse_sweeps=jm.coarse_sweeps,
        coarse_ratio=jm.coarse_ratio, schedule=jm.schedule)
    return ps, pm


@pytest.mark.parametrize("shape,dx,eps", [
    ((16, 16, 16), (1.0, 1.0, 1.0), 1e-9),
    ((16, 14, 12), (1.0, 1.0, 2.0), 1e-8),
])
def test_cg_matches_jax_chunked_loop(shape, dx, eps):
    _, js, _, r0, jm = _jax_problem(shape, dx)
    want = JC._cg_chunked_loop(js, r0, js.b_norm, eps, 500, jm)
    ps, pm = _carry(js, jm)
    hist = PC.ResidualHistory()
    got = PC.cg(ps, torch.from_numpy(np.array(r0)), ps.b_norm, eps, 500,
                precond=pm, history=hist)
    assert int(got.iterations) == int(want.iterations)
    assert bool(got.converged) and bool(want.converged)
    np.testing.assert_allclose(got.z.numpy(), np.asarray(want.z),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(float(got.rel_res), float(want.rel_res),
                               rtol=1e-6)
    assert hist.inner and hist.inner[-1][0] == int(got.iterations)


def test_cg_unpreconditioned_and_maxiter():
    _, js, _, r0, _ = _jax_problem((10, 9, 8), (1.0, 1.0, 1.0), 2,
                                   precond=False)
    ps, _ = _carry(js, None)
    want = JC._cg_chunked_loop(js, r0, js.b_norm, 1e-10, 1000,
                               JP.IdentityPreconditioner())
    got = PC.cg(ps, torch.from_numpy(np.array(r0)), ps.b_norm, 1e-10, 1000)
    assert int(got.iterations) == int(want.iterations)
    np.testing.assert_allclose(got.z.numpy(), np.asarray(want.z),
                               rtol=1e-10, atol=1e-10)
    capped = PC.cg(ps, torch.from_numpy(np.array(r0)), ps.b_norm, 1e-14, 5)
    # maxiter caps the count, as the JAX package's _cg_loop does
    want = JC._cg_loop(js, r0, js.b_norm, 1e-14, 5,
                       JP.IdentityPreconditioner())
    assert int(capped.iterations) == int(want.iterations) == 5
    assert not bool(capped.converged)
    np.testing.assert_allclose(capped.z.numpy(), np.asarray(want.z),
                               rtol=1e-10, atol=1e-10)


def test_solve_system_refinement_matches_jax():
    mask, js, x0, _, _ = _jax_problem((16, 16, 16), (1.0, 1.0, 1.0), 3,
                                      precond=False)
    x_j, info_j = JR.solve_system(js.astype(jnp.float32),
                                  x0.astype(jnp.float32), eps=1e-9,
                                  maxiter=2000, precond="gmg")
    ps = PS.make_tortuosity_system(torch.from_numpy(mask), 0, -1.0, 1.0,
                                   dtype=torch.float32)
    x0p = torch.from_numpy(np.array(x0)).to(torch.float32)
    hist, timings = PC.ResidualHistory(), {}
    x_p, info_p = PR.solve_system(ps, x0p, eps=1e-9, maxiter=2000,
                                  precond="gmg", history=hist,
                                  timings=timings)
    assert x_p.dtype == torch.float64
    assert info_p.converged and bool(info_j.converged)
    assert abs(int(info_p.iterations) - int(info_j.iterations)) <= 2
    np.testing.assert_allclose(x_p.numpy(), np.asarray(x_j), rtol=1e-7,
                               atol=1e-7)
    assert [h[0] for h in hist.outer][0] == 0
    assert {"solve/hierarchy_build", "solve/outer_residual",
            "solve/inner_round"} <= set(timings)
    # pure float64 path (no refinement)
    ps64 = PS.make_tortuosity_system(torch.from_numpy(mask), 0, -1.0, 1.0)
    x_d, info_d = PR.solve_system(ps64, x0p.double(), eps=1e-9, maxiter=2000,
                                  precond="gmg", inner_dtype=None)
    assert bool(info_d.converged)
    np.testing.assert_allclose(x_d.numpy(), np.asarray(x_j), rtol=1e-7,
                               atol=1e-7)
    # restarted FGMRES on the same system reaches the same solution
    x_g, info_g = PR.solve_system(ps, x0p, eps=1e-9, maxiter=2000,
                                  method="fgmres", precond="gmg")
    assert info_g.converged and x_g.dtype == torch.float64
    np.testing.assert_allclose(x_g.numpy(), np.asarray(x_j), rtol=1e-7,
                               atol=1e-7)
