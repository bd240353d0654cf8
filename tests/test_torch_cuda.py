"""PyTorch port on the card: kernels K1 to K5 against their plain PyTorch
versions at small shapes, and the entry points on the GPU against the CPU.

Marked ``cuda``; each test skips without a CUDA device.  Imports no JAX, so
it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from openimpala_tpu_torch import (  # noqa: E402
    effective_diffusivity, rev_study, tortuosity)
from openimpala_tpu_torch.ops import offset as po  # noqa: E402
from openimpala_tpu_torch.ops import offset_cuda as oc  # noqa: E402
from openimpala_tpu_torch.ops import stencil as st  # noqa: E402
from openimpala_tpu_torch.ops import stencil_cuda as sc  # noqa: E402
from openimpala_tpu_torch.solve.preconditioners import (  # noqa: E402
    GalerkinMGPreconditioner, fine_conductances)
from openimpala_tpu_torch.solve.sa import (  # noqa: E402
    OffsetLevel, SAMGPreconditioner)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.float64: dict(rtol=1e-12, atol=1e-12)}
# K3 sums up to 125 products: the JAX package's own kernel tolerance
K3_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
          torch.float64: dict(rtol=1e-12, atol=1e-12)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _system(kind, shape, dx, dtype, device):
    mask = torch.from_numpy(np.random.default_rng(0).random(shape) < 0.7)
    if kind == "flow":
        return st.make_tortuosity_system(mask.to(device), 0, -1.0, 1.0, dx=dx,
                                         dtype=dtype)
    return st.make_cell_problem_system(mask.to(device), 1, dx=dx,
                                       dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind,shape,dx", [
    ("flow", (20, 18, 16), (1.0, 1.0, 1.0)),
    ("flow", (21, 17, 13), (1.0, 0.5, 2.0)),
    ("cell", (16, 12, 10), (1.0, 1.0, 1.0)),
    ("cell", (9, 7, 5), (1.0, 0.5, 2.0)),
])
def test_k1_k2_match_plain(cuda, kind, shape, dx, dtype):
    s = _system(kind, shape, dx, dtype, cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.where(s.free, torch.randn(shape, generator=g, dtype=dtype,
                                        device=cuda), 0.0)
    r = torch.where(s.free, torch.randn(shape, generator=g, dtype=dtype,
                                        device=cuda), 0.0)
    code, w, per = s.code, s.w, s.periodic
    out, dot = st.apply_code_with_dot(x, code, w, per)
    want, wdot = st.apply_code_with_dot_plain(x, code, w, per)
    torch.testing.assert_close(out, want, **TOL[dtype])
    torch.testing.assert_close(dot, wdot, rtol=1e-4, atol=0.0)
    assert torch.equal(dot, st.apply_code_with_dot(x, code, w, per)[1])
    torch.testing.assert_close(st.residual_restricted(x, r, code, w, per),
                               st.residual_restricted_plain(x, r, code, w,
                                                            per),
                               **TOL[dtype])
    torch.testing.assert_close(st.smooth_sweep(x, r, code, w, per, 0.9),
                               st.smooth_sweep_plain(x, r, code, w, per, 0.9),
                               **TOL[dtype])
    if all(n % 2 == 0 for n in shape):
        torch.testing.assert_close(
            st.residual_restrict(x, r, code, w, per),
            st.residual_restrict_plain(x, r, code, w, per), **TOL[dtype])
    else:
        with pytest.raises(ValueError, match="even"):
            st.residual_restrict(x, r, code, w, per)
    levels = (fine_conductances(s),) + GalerkinMGPreconditioner.from_system(
        s).levels
    for lvl in levels:
        xl = torch.randn(lvl.diag.shape, generator=g, dtype=dtype, device=cuda)
        rl = torch.randn(lvl.diag.shape, generator=g, dtype=dtype, device=cuda)
        torch.testing.assert_close(lvl.apply(xl), lvl.apply_plain(xl),
                                   **TOL[dtype])
        torch.testing.assert_close(lvl.sweep(xl, rl, 0.9),
                                   lvl.sweep_plain(xl, rl, 0.9), **TOL[dtype])
        for got, want in zip(lvl.cheby_init(rl, 0.7),
                             lvl.cheby_init_plain(rl, 0.7)):
            torch.testing.assert_close(got, want, **TOL[dtype])
        state = (rl, xl, torch.randn(lvl.diag.shape, generator=g,
                                     dtype=dtype, device=cuda))
        got = lvl.cheby_step(*(t.clone() for t in state), 0.5, 0.25)
        for got_t, want_t in zip(got, lvl.cheby_step_plain(*state, 0.5,
                                                           0.25)):
            torch.testing.assert_close(got_t, want_t, **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind,shape,dx,plan", [
    # the general route on tiny extents and on rows that are no whole vectors
    ("cell", (1, 1, 1), (1.0, 1.0, 1.0), {}),
    ("cell", (2, 2, 2), (1.0, 1.0, 1.0), {}),
    ("cell", (3, 2, 1), (1.0, 0.5, 2.0), {}),
    ("flow", (16, 24, 129), (1.0, 1.0, 1.0), {}),
    ("cell", (16, 24, 127), (1.0, 1.0, 1.0), {}),
    # the stream route at its seams: ragged tiles, short and uneven runs,
    # periodic wraps, anisotropic packing, one and two rows per thread
    ("flow", (16, 24, 128), (1.0, 1.0, 1.0), {"route": "stream"}),
    ("flow", (16, 24, 132), (1.0, 1.0, 1.0), {"route": "stream"}),
    ("cell", (16, 24, 252), (1.0, 1.0, 1.0), {"route": "stream"}),
    ("cell", (6, 4, 128), (1.0, 0.5, 2.0), {"route": "stream"}),
    ("flow", (65, 20, 516), (1.0, 1.0, 1.0), {"route": "stream", "run": 16}),
    ("cell", (33, 17, 260), (1.0, 1.0, 1.0), {"route": "stream", "run": 16}),
    ("cell", (1, 1, 128), (1.0, 1.0, 1.0), {"route": "stream"}),
    ("flow", (128, 64, 256), (1.0, 0.5, 2.0), {"route": "stream"}),
    ("cell", (64, 48, 256), (1.0, 0.5, 2.0),
     {"route": "stream", "rows": 2, "run": 22}),
    ("flow", (64, 48, 256), (1.0, 1.0, 1.0),
     {"route": "stream", "rows": 1, "run": 20}),
])
def test_k1_routes_match_plain_at_their_seams(cuda, kind, shape, dx, plan,
                                              dtype):
    s = _system(kind, shape, dx, dtype, cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.where(s.free, torch.randn(shape, generator=g, dtype=dtype,
                                        device=cuda), 0.0)
    r = torch.where(s.free, torch.randn(shape, generator=g, dtype=dtype,
                                        device=cuda), 0.0)
    code, w, per = s.code, s.w, s.periodic
    sc.reset_counts()
    out, dot = sc.k1_stencil("matvec", x, None, code, w, per, with_dot=True,
                             **plan)
    want, wdot = st.apply_code_with_dot_plain(x, code, w, per)
    torch.testing.assert_close(out, want, **TOL[dtype])
    # atol: a wrapped axis of extent 1 or 2 makes the operator singular
    # and the dot pure rounding of terms of size d x^2
    torch.testing.assert_close(dot, wdot, rtol=1e-4, atol=1e-5)
    assert torch.equal(dot, sc.k1_stencil("matvec", x, None, code, w, per,
                                          with_dot=True, **plan)[1])
    torch.testing.assert_close(
        sc.k1_stencil("matvec", x, None, code, w, per, **plan), want,
        **TOL[dtype])
    torch.testing.assert_close(
        sc.k1_stencil("resid", x, r, code, w, per, **plan),
        st.residual_restricted_plain(x, r, code, w, per), **TOL[dtype])
    torch.testing.assert_close(
        sc.k1_stencil("sweep", x, r, code, w, per, omega=0.9, **plan),
        st.smooth_sweep_plain(x, r, code, w, per, 0.9), **TOL[dtype])
    if plan.get("rows", 2) == 2 and all(n % 2 == 0 for n in shape):
        torch.testing.assert_close(
            sc.k1_stencil("restrict", x, r, code, w, per, **plan),
            st.residual_restrict_plain(x, r, code, w, per), **TOL[dtype])
    # every launch took the route the case names
    assert {k[1] for k in sc.launches_route} == {plan.get("route", "general")}
    assert sum(sc.launches_route.values()) == sum(sc.launches.values())


def test_k1_rule_sends_a_large_volume_down_the_stream(cuda):
    shape = (160, 128, 512)
    assert sc.k1_route(shape, torch.float32) == "stream"
    s = _system("flow", shape, (1.0, 1.0, 1.0), torch.float32, cuda)
    x = torch.where(s.free, torch.randn(shape, device=cuda), 0.0)
    sc.reset_counts()
    out = st.apply_code(x, s.code, s.w, s.periodic)  # the dispatcher
    assert dict(sc.launches_route) == {("k1_matvec_f32", "stream"): 1}
    assert sc.launches_route_at["k1_matvec_f32", "stream", shape] == 1
    torch.testing.assert_close(
        out, sc.k1_stencil("matvec", x, None, s.code, s.w, s.periodic,
                           route="general"), **TOL[torch.float32])
    with pytest.raises(ValueError, match="cannot take"):
        sc.k1_stencil("matvec", x[:, :, :97].contiguous(), None,
                      s.code[:, :, :97].contiguous(), s.w, s.periodic,
                      route="stream")


def test_wrappers_refuse_bad_inputs(cuda):
    x = torch.zeros((4, 4, 4), device=cuda)
    code = torch.zeros((4, 4, 4), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        sc.k1_stencil("matvec", x.transpose(0, 2), None, code, (1.0,) * 3,
                      (False,) * 3)
    with pytest.raises(ValueError, match="float32 or float64"):
        sc.k1_stencil("matvec", x.half(), None, code, (1.0,) * 3,
                      (False,) * 3)
    with pytest.raises(ValueError, match="bfloat16"):
        sc.k1_stencil("matvec", x, None, code.float(), (1.0,) * 3,
                      (False,) * 3)
    with pytest.raises(ValueError, match="r"):
        sc.k1_stencil("sweep", x, None, code, (1.0,) * 3, (False,) * 3)


def _offset_level(shape, radius, dtype, device):
    """Random coefficients on every offset of [-radius, radius]^3; the
    diagonal has exact zeros and stays away from (0, 0.9)."""
    rad = range(-radius, radius + 1)
    offsets, nn = po.order_offsets(
        (i, j, k) for i in rad for j in rad for k in rad)
    c = np.random.default_rng(2).standard_normal(
        (shape[0], len(offsets)) + tuple(shape[1:]))
    c[:, 0] = np.where(np.abs(c[:, 0]) < 0.3, 0.0, 3.0 * c[:, 0])
    return OffsetLevel(packed=torch.from_numpy(c).to(device=device,
                                                    dtype=dtype),
                       offsets=offsets, nn=nn)


@pytest.mark.parametrize("coeff", ["full", "bf16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,radius", [
    ((13, 10, 9), 1), ((13, 10, 9), 2), ((4, 4, 4), 2), ((3, 2, 1), 2),
])
def test_k3_matches_plain(cuda, shape, radius, dtype, coeff):
    lvl = _offset_level(shape, radius,
                        dtype if coeff == "full" else torch.bfloat16, cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(shape, generator=g, dtype=dtype, device=cuda)
    r = torch.randn(shape, generator=g, dtype=dtype, device=cuda)
    pk, offs = lvl.packed, lvl.offsets
    sc.reset_counts()
    torch.testing.assert_close(lvl.apply(x),
                               po.offset_apply_plain(x, pk, offs),
                               **K3_TOL[dtype])
    torch.testing.assert_close(
        lvl.apply_nn(x),
        po.offset_apply_plain(x, pk, offs, n_taps=lvl.nn), **K3_TOL[dtype])
    torch.testing.assert_close(lvl.resid(x, r),
                               po.offset_resid_plain(x, r, pk, offs),
                               **K3_TOL[dtype])
    torch.testing.assert_close(lvl.sweep(x, r, 0.9),
                               po.offset_sweep_plain(x, r, pk, offs, 0.9),
                               **K3_TOL[dtype])
    tag = "f32" if dtype == torch.float32 else "f64"
    prefix = "apply_prefix" if lvl.nn < len(offs) else "apply"
    assert sc.launches[f"k3_{prefix}_{tag}"] >= 1
    assert sc.launches[f"k3_resid_{tag}"] == sc.launches[
        f"k3_sweep_{tag}"] == 1
    assert sc.launches_at[f"k3_sweep_{tag}", tuple(shape)] == 1
    assert sum(sc.launches_at.values()) == sum(
        n for k, n in sc.launches.items() if k.startswith("k3_"))
    # the dispatchers launched; only the references above were plain
    assert set(sc.plain_on_cuda) == {"k3_apply", "k3_resid", "k3_sweep"}


def test_k3_refuses_bad_inputs(cuda):
    lvl = _offset_level((4, 4, 4), 1, torch.float32, cuda)
    x = torch.zeros((4, 4, 4), device=cuda)
    pk, offs = lvl.packed, lvl.offsets
    with pytest.raises(ValueError, match="packed must be bfloat16 or"):
        oc.k3_offset("apply", x, None, pk.double(), offs)
    with pytest.raises(ValueError, match="packed shape"):
        oc.k3_offset("apply", x, None, pk[:, :5].contiguous(), offs)
    with pytest.raises(ValueError, match="contiguous"):
        oc.k3_offset("apply", x, None,
                     pk.transpose(2, 3).contiguous().transpose(2, 3), offs)
    with pytest.raises(ValueError, match="n_taps"):
        oc.k3_offset("apply", x, None, pk, offs, n_taps=0)
    with pytest.raises(ValueError, match="r is required"):
        oc.k3_offset("sweep", x, None, pk, offs)
    with pytest.raises(ValueError, match=r"\(0,0,0\)"):
        oc.k3_offset("resid", x, x, pk[:, 1:].contiguous(), offs[1:])
    with pytest.raises(ValueError, match="float32 or float64"):
        oc.k3_offset("apply", x.half(), None, pk, offs)


@pytest.mark.parametrize("kind,shape", [("flow", (24, 20, 16)),
                                        ("cell", (20, 20, 20))])
def test_sa_hierarchy_gpu_matches_cpu(cuda, kind, shape):
    """The probed hierarchy (K1 and K3 do the probing on the card) and one
    V-cycle against the CPU build in float64."""
    gpu = SAMGPreconditioner.from_system(
        _system(kind, shape, (1.0, 1.0, 1.0), torch.float64, cuda))
    cpu = SAMGPreconditioner.from_system(
        _system(kind, shape, (1.0, 1.0, 1.0), torch.float64, "cpu"))
    assert len(gpu.levels) == len(cpu.levels) == 2
    for a, b in zip(gpu.levels, cpu.levels):
        assert a.offsets == b.offsets and a.nn == b.nn
        torch.testing.assert_close(a.packed.cpu(), b.packed, rtol=1e-12,
                                   atol=1e-12)
    r = torch.where(cpu.fine.free, torch.from_numpy(
        np.random.default_rng(4).standard_normal(shape)), 0.0)
    sc.reset_counts()
    torch.testing.assert_close(gpu(r.to(cuda)).cpu(), cpu(r), rtol=1e-10,
                               atol=1e-10)
    assert sc.launches["k3_sweep_f64"] > 0 and not sc.plain_on_cuda


@pytest.mark.parametrize("precond", ["auto", "sa"])
def test_tortuosity_gpu_matches_cpu(cuda, precond):
    vol = (np.random.default_rng(7).random((20, 18, 16)) < 0.65).astype(
        np.int32)
    sc.reset_counts()
    gpu = tortuosity(vol, 1, "Y", precond=precond, device=cuda)
    assert sc.launches["k1_matvec_dot_f32"] >= gpu.iterations
    assert (sc.launches["k3_sweep_f32"] > 0) == (precond == "sa")
    assert not sc.plain_on_cuda
    cpu = tortuosity(vol, 1, "Y", precond=precond, device="cpu")
    assert abs(gpu.value - cpu.value) <= 1e-6 * abs(cpu.value)
    assert gpu.active_vf == cpu.active_vf
    assert abs(gpu.iterations - cpu.iterations) <= 1


def _restricted_case(shape, lanes, diag_form, dtype, device, seed=5):
    """(x, diag, free) for the explicit operator: ``lanes`` 0 means one
    unbatched volume."""
    full = ((lanes,) if lanes else ()) + tuple(shape)
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(full, generator=g, dtype=dtype, device=device)
    free = torch.rand(full, generator=g, device=device) < 0.7
    if diag_form == "scalar":
        diag = torch.full((), 6.5, dtype=dtype, device=device)
    elif diag_form == "lane":
        diag = 6.0 + torch.rand((lanes,), generator=g, dtype=dtype,
                                device=device)
    else:
        diag = 6.0 + torch.rand(full, generator=g, dtype=dtype, device=device)
    return x, diag, free


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("periodic", [(False, False, False),
                                      (True, True, True),
                                      (True, False, True)])
@pytest.mark.parametrize("shape,lanes,diag_form", [
    ((20, 18, 16), 0, "full"), ((21, 17, 13), 0, "scalar"),
    ((9, 7, 5), 3, "full"), ((9, 7, 5), 3, "lane"), ((9, 7, 5), 1, "scalar"),
    ((1, 2, 3), 2, "full"), ((2, 1, 1), 0, "full"), ((33, 9, 40), 5, "lane"),
])
def test_k4_matches_plain(cuda, shape, lanes, diag_form, periodic, dtype):
    w = (1.0, 4.0, 0.25)
    x, diag, free = _restricted_case(shape, lanes, diag_form, dtype, cuda)
    sc.reset_counts()
    out = sc.k4_matvec(x, diag, free, w, periodic)
    out2, dot = sc.k4_matvec(x, diag, free.to(torch.int8), w, periodic,
                             with_dot=True)
    tag = "f32" if dtype == torch.float32 else "f64"
    assert sc.launches == {f"k4_matvec_{tag}": 1, f"k4_matvec_dot_{tag}": 1}
    want, wdot = st.apply_restricted_with_dot_plain(x, diag, free, w,
                                                    periodic)
    torch.testing.assert_close(out, want, **TOL[dtype])
    assert torch.equal(out, out2)
    assert dot.shape == wdot.shape
    torch.testing.assert_close(dot, wdot, rtol=1e-4, atol=1e-4)
    assert torch.equal(dot, sc.k4_matvec(x, diag, free, w, periodic,
                                         with_dot=True)[1])
    if lanes:  # the wrap never crosses a lane
        for b in range(lanes):
            db = diag if diag_form == "scalar" else diag[b]
            torch.testing.assert_close(
                sc.k4_matvec(x[b].contiguous(), db.contiguous(),
                             free[b].contiguous(), w, periodic),
                out[b], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("periodic", [(False, False, False),
                                      (True, True, True),
                                      (False, True, False)])
@pytest.mark.parametrize("shape", [(20, 18, 16), (21, 17, 13), (40, 9, 33),
                                   (1, 2, 3), (2, 1, 1), (3, 40, 70)])
def test_k5_matches_plain_and_k4(cuda, shape, periodic, dtype):
    w = (1.0, 0.25, 4.0)
    x, diag, free = _restricted_case(shape, 0, "full", dtype, cuda)
    sc.reset_counts()
    out = st.apply_restricted(x, diag, free, w, periodic)  # the dispatcher
    tag = "f32" if dtype == torch.float32 else "f64"
    assert sc.launches == {f"k5_matvec_{tag}": 1} and not sc.plain_on_cuda
    torch.testing.assert_close(
        out, st.apply_restricted_plain(x, diag, free, w, periodic),
        **TOL[dtype])
    torch.testing.assert_close(out, sc.k4_matvec(x, diag, free, w, periodic),
                               **TOL[dtype])
    # with the dot, a scalar diag or a batch the dispatcher takes K4
    st.apply_restricted_with_dot(x, diag, free, w, periodic)
    st.apply_restricted(x, diag.flatten()[0].clone(), free, w, periodic)
    st.apply_restricted(x[None], diag[None], free[None], w, periodic)
    assert sc.launches[f"k4_matvec_dot_{tag}"] == 1
    assert sc.launches[f"k4_matvec_{tag}"] == 3  # one above, two here
    assert sc.launches[f"k5_matvec_{tag}"] == 1


def test_k4_k5_refuse_bad_inputs(cuda):
    x = torch.zeros((2, 4, 4, 4), device=cuda)
    free = torch.ones((2, 4, 4, 4), dtype=torch.bool, device=cuda)
    w, per = (1.0,) * 3, (True,) * 3
    with pytest.raises(ValueError, match="diag shape"):
        sc.k4_matvec(x, torch.zeros(3, device=cuda), free, w, per)
    with pytest.raises(ValueError, match="diag must be torch.float32"):
        sc.k4_matvec(x, torch.zeros((), dtype=torch.float64, device=cuda),
                     free, w, per)
    with pytest.raises(ValueError, match="bool or int8"):
        sc.k4_matvec(x, torch.zeros((), device=cuda), free.float(), w, per)
    with pytest.raises(ValueError, match="contiguous"):
        sc.k4_matvec(x.transpose(1, 3), torch.zeros((), device=cuda),
                     free.transpose(1, 3), w, per)
    with pytest.raises(ValueError, match="3-D"):
        sc.k5_matvec_stream(x, x, free, w, per)
    with pytest.raises(ValueError, match="diag"):
        sc.k5_matvec_stream(x[0], torch.zeros((), device=cuda), free[0], w,
                            per)


def test_effective_diffusivity_gpu_matches_cpu(cuda):
    vol = (np.random.default_rng(7).random((20, 18, 16)) < 0.65).astype(
        np.int32)
    for precond, kernel in (("auto", "k2_sweep_f32"),
                            ("cheby", "k5_matvec_f32")):
        sc.reset_counts()
        gpu = effective_diffusivity(vol, 1, precond=precond, device=cuda)
        assert sc.launches[kernel] > 0 and not sc.plain_on_cuda
        cpu = effective_diffusivity(vol, 1, precond=precond, device="cpu")
        assert gpu.converged and cpu.converged
        np.testing.assert_allclose(gpu.deff, cpu.deff, rtol=0, atol=1e-6)
        for g, c in zip(gpu.iterations, cpu.iterations):
            assert abs(g - c) <= 1


def test_rev_study_gpu_matches_cpu(cuda):
    vol = (np.random.default_rng(8).random((24, 24, 24)) < 0.65).astype(
        np.int32)
    sc.reset_counts()
    gpu = rev_study(vol, 1, sizes=(12,), num_samples=3, device=cuda)
    assert sc.launches["k4_matvec_f32"] >= 11 * sc.launches[
        "k4_matvec_dot_f32"] > 0
    assert sc.launches["k4_matvec_f64"] > 0 and not sc.plain_on_cuda
    cpu = rev_study(vol, 1, sizes=(12,), num_samples=3, device="cpu")
    for g, c in zip(gpu, cpu):
        assert g.converged and c.converged and g.seed == c.seed
        np.testing.assert_allclose(g.deff, c.deff, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(33, 40, 24), (100, 17, 9), (5, 64, 3),
                                   (64, 32, 32)])
def test_device_fill_matches_host(cuda, shape):
    from openimpala_tpu_torch.ops.floodfill import percolation_mask

    vol = (np.random.default_rng(9).random(shape) < 0.5).astype(np.uint8)
    vol_t = torch.from_numpy(vol).to(cuda)
    for d in range(3):
        want, want_vf = percolation_mask(vol, 1, d, method="host")
        for phase in (vol, vol_t):  # a numpy volume and one on the card
            got, vf = percolation_mask(phase, 1, d, method="device",
                                       device=cuda)
            assert got.is_cuda and got.dtype == torch.bool
            np.testing.assert_array_equal(got.cpu().numpy(), want)
            assert vf == want_vf


def test_packed_words_on_card_match_cpu(cuda):
    """The int32 arithmetic (wrap of o + 1, masked right shifts, the top
    bit as the sign) gives the same bits on the card as on the CPU."""
    from openimpala_tpu_torch.ops import packfill as pp

    rng = np.random.default_rng(3)
    edge = np.array([0x7FFFFFFF, 0xFFFFFFFF, 0x80000000, 0, 1, 0x7FFFFFFE,
                     0x80000001, 0x55555555], np.uint32).view(np.int32)
    w = torch.from_numpy(edge)
    for fn in (pp._low_run, pp._high_run, lambda x: pp._srl(x, 31),
               lambda x: pp._ks_fill_up(x, x & 1)):
        assert torch.equal(fn(w.to(cuda)).cpu(), fn(w))
    o = torch.from_numpy(rng.integers(0, 2 ** 32, (3, 17, 9), dtype=np.uint64)
                         .astype(np.uint32).view(np.int32))
    r = o & torch.from_numpy(rng.integers(0, 2 ** 32, (3, 17, 9),
                                          dtype=np.uint64)
                             .astype(np.uint32).view(np.int32))
    assert torch.equal(pp.fill_round(o.to(cuda), r.to(cuda)).cpu(),
                       pp.fill_round(o, r))
    m = torch.from_numpy(rng.random((70, 6, 5)) < 0.5)
    assert torch.equal(pp.pack_x(m.to(cuda)).cpu(), pp.pack_x(m))
    assert torch.equal(pp.unpack_x(pp.pack_x(m.to(cuda)), 70).cpu(), m)


def test_lanes_match_sequential_on_card(cuda):
    from openimpala_tpu_torch.utils.sample_data import make_blobs

    vol = make_blobs(32, 0.4, 0)
    sc.reset_counts()
    lanes = effective_diffusivity(vol, 1, lanes=True, device=cuda)
    assert sc.launches["k1_matvec_dot_f32"] >= sum(lanes.iterations)
    assert not sc.plain_on_cuda
    seq = effective_diffusivity(vol, 1, lanes=False, device=cuda)
    assert lanes.converged and seq.converged
    np.testing.assert_allclose(lanes.deff, seq.deff, rtol=0, atol=1e-9)
    for a, b in zip(lanes.iterations, seq.iterations):
        assert abs(a - b) <= 1


def test_tortuosity_percolation_on_card(cuda):
    from openimpala_tpu_torch.ops.floodfill import auto_method

    vol = (np.random.default_rng(7).random((40, 18, 16)) < 0.65).astype(
        np.int32)
    cpu = tortuosity(vol, 1, "X", device="cpu", return_fields=True)
    assert cpu.percolation_method == "host"
    for method in ("auto", "device", "native", "host"):
        t = {}
        gpu = tortuosity(torch.from_numpy(vol).to(cuda), 1, "X",
                         percolation_method=method, device=cuda,
                         return_fields=True, timings=t)
        want = auto_method(vol.shape, cuda) if method == "auto" else method
        assert gpu.percolation_method == want
        assert gpu.active.is_cuda
        assert torch.equal(gpu.active.cpu(), cpu.active)
        assert gpu.active_vf == cpu.active_vf
        assert ("phase_upload" in t) == (want == "device")
        assert abs(gpu.value - cpu.value) <= 1e-6 * abs(cpu.value)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind,dx", [("flow", (1.0, 1.0, 1.0)),
                                     ("flow", (1.0, 1.0, 2.0)),
                                     ("cell", (1.0, 1.0, 1.0)),
                                     ("cell", (1.0, 1.0, 2.0))])
def test_k1_on_mg_hierarchy_levels(cuda, kind, dx, dtype):
    """K1 on every level of ``precond="mg"``'s hierarchy, 32^3 down to 4^3
    (periodic wraps on 4-long axes; the constant codes 6 and 42 of the
    periodic cell problem; coarse free cells that pack to 0), against the
    plain forms; the codes equal the CPU build's bit for bit; one cycle
    against the CPU in float64."""
    from openimpala_tpu_torch.solve.preconditioners import (
        MultigridPreconditioner)

    shape = (32, 32, 32)
    gpu = MultigridPreconditioner.from_system(
        _system(kind, shape, dx, dtype, cuda))
    cpu = MultigridPreconditioner.from_system(
        _system(kind, shape, dx, dtype, "cpu"))
    assert [tuple(lv.code.shape) for lv in gpu.levels] == [
        (32,) * 3, (16,) * 3, (8,) * 3, (4,) * 3]
    g = torch.Generator(device=cuda).manual_seed(11)
    for lv, lc in zip(gpu.levels, cpu.levels):
        assert torch.equal(lv.code.cpu().view(torch.int16),
                           lc.code.view(torch.int16))
        code, w, per = lv.code, lv.w, lv.periodic
        n = tuple(code.shape)
        x = torch.where(lv.free, torch.randn(n, generator=g, dtype=dtype,
                                             device=cuda), 0.0)
        r = torch.where(lv.free, torch.randn(n, generator=g, dtype=dtype,
                                             device=cuda), 0.0)
        sc.reset_counts()
        torch.testing.assert_close(lv.apply(x),
                                   st.apply_code_plain(x, code, w, per),
                                   **TOL[dtype])
        torch.testing.assert_close(lv.sweep(x, r, 0.8),
                                   st.smooth_sweep_plain(x, r, code, w, per,
                                                         0.8), **TOL[dtype])
        torch.testing.assert_close(lv.resid(x, r),
                                   st.residual_restricted_plain(x, r, code,
                                                                w, per),
                                   **TOL[dtype])
        torch.testing.assert_close(lv.resid_restrict(x, r),
                                   st.residual_restrict_plain(x, r, code, w,
                                                              per),
                                   **TOL[dtype])
        # a free-packed cell with no free neighbour (code 0) is not free:
        # the sweep leaves it as it was
        zero = code == 0
        assert torch.equal(lv.sweep(x, r, 0.8)[zero], x[zero])
        assert {k[2] for k in sc.launches_route_at} == {n}
    codes = {float(v) for v in gpu.levels[-1].code.float().unique()}
    if kind == "cell":
        assert codes <= {-1.0, 6.0 if dx[2] == 1.0 else 42.0}
    if dtype == torch.float64:
        r = torch.where(cpu.levels[0].free, torch.from_numpy(
            np.random.default_rng(4).standard_normal(shape)), 0.0)
        sc.reset_counts()
        torch.testing.assert_close(gpu(r.to(cuda)).cpu(), cpu(r), rtol=1e-10,
                                   atol=1e-10)
        assert {k[2] for k in sc.launches_route_at} == {
            (32,) * 3, (16,) * 3, (8,) * 3, (4,) * 3}
        assert not any(k.startswith("k2_") for k in sc.launches)
        assert not sc.plain_on_cuda


@pytest.mark.parametrize("opts", [{"transfer": "tri"}, {"cycle": "w"},
                                  {"smoother": "cheby"}])
@pytest.mark.parametrize("kind", ["flow", "cell"])
def test_galerkin_options_gpu_match_cpu(cuda, kind, opts):
    """One cycle of each option of the default cycle on the card against
    the CPU in float64; the Chebyshev smoother launches no sweep kernel."""
    shape = (24, 16, 32)
    gpu = GalerkinMGPreconditioner.from_system(
        _system(kind, shape, (1.0, 1.0, 1.0), torch.float64, cuda), **opts)
    cpu = GalerkinMGPreconditioner.from_system(
        _system(kind, shape, (1.0, 1.0, 1.0), torch.float64, "cpu"), **opts)
    r = torch.where(cpu.fine.free, torch.from_numpy(
        np.random.default_rng(5).standard_normal(shape)), 0.0)
    sc.reset_counts()
    torch.testing.assert_close(gpu(r.to(cuda)).cpu(), cpu(r), rtol=1e-10,
                               atol=1e-10)
    assert not sc.plain_on_cuda and sc.launches["k2_matvec_f64"] > 0
    # the coarsest solve, and the Chebyshev smoother on level 1, run K2's
    # fused steps
    assert sc.launches["k2_cheby_init_f64"] > 0
    assert sc.launches["k2_cheby_f64"] > 0
    if opts.get("smoother") == "cheby":
        assert not any("sweep" in k for k in sc.launches)
        assert sc.launches["k1_matvec_f64"] > 0
    else:
        assert sc.launches["k1_sweep_f64"] > 0
    if opts.get("transfer") == "tri":
        assert sc.launches["k1_resid_f64"] > 0
        assert "k1_restrict_f64" not in sc.launches


@pytest.mark.parametrize("precond", ["gmg", "jacobi"])
@pytest.mark.parametrize("kind", ["flow", "cell"])
def test_fgmres_cycle_gpu_matches_cpu(cuda, kind, precond):
    """One FGMRES restart cycle on the card against the CPU in float64:
    the same Arnoldi steps, z and r to 1e-10."""
    from openimpala_tpu_torch.solve import fgmres as pf
    from openimpala_tpu_torch.solve.refine import make_precond

    shape = (24, 20, 16)
    out = {}
    for dev in (cuda, "cpu"):
        s = _system(kind, shape, (1.0, 1.0, 1.0), torch.float64, dev)
        r0 = (s.initial_residual(torch.zeros(shape, dtype=torch.float64,
                                             device=dev))
              if kind == "flow" else s.r0_b)
        sc.reset_counts()
        out[str(dev)] = pf._arnoldi_cycle(s, make_precond(s, precond),
                                          torch.zeros_like(r0), r0, r0,
                                          0.0, 12)
        if dev == cuda:
            assert sc.launches["k1_matvec_f64"] >= 12
            assert not sc.plain_on_cuda
    (zg, rg, ng, kg), (zc, rc, nc, kc) = out["cuda"], out["cpu"]
    assert kg == kc == 12
    torch.testing.assert_close(zg.cpu(), zc, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(rg.cpu(), rc, rtol=1e-10, atol=1e-10)
    assert abs(float(ng) - float(nc)) <= 1e-10 * max(1.0, float(nc))


@pytest.mark.parametrize("kw", [{"precond": "mg"},
                                {"precond_opts": {"transfer": "tri"}},
                                {"precond_opts": {"cycle": "w"}},
                                {"precond_opts": {"smoother": "cheby"}},
                                {"method": "fgmres"}, {"method": "gmres",
                                                       "precond": "mg"}])
def test_slice_solvers_gpu_match_cpu(cuda, kw):
    vol = (np.random.default_rng(7).random((24, 20, 16)) < 0.65).astype(
        np.int32)
    sc.reset_counts()
    gpu = tortuosity(vol, 1, "X", device=cuda, **kw)
    assert gpu.converged and not sc.plain_on_cuda
    if kw.get("precond") == "mg":
        assert not any(k.startswith("k2_") for k in sc.launches)
    cpu = tortuosity(vol, 1, "X", device="cpu", **kw)
    assert abs(gpu.value - cpu.value) <= 1e-6 * abs(cpu.value)
    assert abs(gpu.iterations - cpu.iterations) <= 2


def test_effective_diffusivity_keeps_a_cuda_phase_on_the_card(
        cuda, monkeypatch):
    """A phase on the card is masked and counted there: no copy of it to
    the host, and the tensor of a numpy phase."""
    vol = (np.random.default_rng(7).random((20, 18, 16)) < 0.65).astype(
        np.int32)
    phase = torch.from_numpy(vol).to(cuda)
    copied = []
    for name in ("cpu", "to", "numpy"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, _name=name, **kw):
            out = _orig(self, *a, **kw)
            if self.data_ptr() == phase.data_ptr() and (
                    not isinstance(out, torch.Tensor) or not out.is_cuda):
                copied.append(_name)
            return out

        monkeypatch.setattr(torch.Tensor, name, spy)
    sc.reset_counts()
    got = effective_diffusivity(phase, 1, precond="mg", device=cuda)
    monkeypatch.undo()
    assert not copied and not sc.plain_on_cuda
    want = effective_diffusivity(vol, 1, precond="mg", device=cuda)
    assert got.volume_fraction == want.volume_fraction == float(
        (vol == 1).mean())
    np.testing.assert_array_equal(got.deff, want.deff)
    assert got.iterations == want.iterations


# ---------------------------------------------------------------------------
# CUDA graphs of the chunks (utils/graphs.py): every graphed solve against
# its eager twin on the card, bit for bit, launch counters included
# ---------------------------------------------------------------------------

def _counts():
    return {k: dict(v) for k, v in sc.snapshot_counts().items()}


def _less(counts, surplus):
    """Launch counters less the launches of the steps a graphed PCG loop
    ran past its count (``graphs.surplus_counts``)."""
    return {k: dict(+(collections.Counter(v)
                      - surplus.get(k, collections.Counter())))
            for k, v in counts.items()}


def _twin(call):
    """``call()`` graphed, then inside ``_eager_twin()``; each with the
    launch counters reset just before.  Returns both results, both counts
    (the graphed run's less the launches of the done-gated steps it ran
    past its count) and the graph statistics of the graphed run.  The
    eager twin executes exactly the iterations it counts, the graphed run
    counts as many and executes at most ``IN_FLIGHT`` more per PCG
    call."""
    from openimpala_tpu_torch.utils import graphs

    sc.reset_counts()
    graphs.reset_stats()
    got = call()
    torch.cuda.synchronize()
    stats = dict(graphs.stats)
    counts = _less(_counts(), graphs.surplus_counts)
    sc.reset_counts()
    graphs.reset_stats()
    with graphs._eager_twin():
        want = call()
    torch.cuda.synchronize()
    twin = dict(graphs.stats)
    assert twin["steps"] == twin["reads"] == stats["reads"]
    assert twin["calls"] == stats["calls"]
    assert 0 <= stats["steps"] - stats["reads"] <= \
        graphs.IN_FLIGHT * stats["calls"]
    return got, want, counts, _less(_counts(), {}), stats


def _blob_system(cuda, n=32, kind="flow", dtype=torch.float32):
    from openimpala_tpu_torch.utils.sample_data import make_blobs

    active = torch.from_numpy(make_blobs(n, 0.4, 0) == 1).to(cuda)
    if kind == "flow":
        return st.make_tortuosity_system(active, 0, -1.0, 1.0, dtype=dtype)
    return st.make_cell_problem_system(active, 0, dtype=dtype)


@pytest.mark.parametrize("precond", ["gmg", "mg", "sa", "cheby", "jacobi",
                                     "none"])
def test_graphed_cg_equals_eager(cuda, precond):
    from openimpala_tpu_torch.solve.cg import cg
    from openimpala_tpu_torch.solve.refine import make_precond
    from openimpala_tpu_torch.utils import graphs

    s = _blob_system(cuda, 48, dtype=torch.float64)
    M = make_precond(s, precond)
    r0 = s.initial_residual(torch.zeros_like(s.r0_b))
    got, want, cg_, ce, stats = _twin(
        lambda: cg(s, r0, s.b_norm, 1e-13, 3000, precond=M))
    assert torch.equal(got.z, want.z)
    its = int(got.iterations)
    assert its == int(want.iterations) and its > 16
    assert torch.equal(got.rel_res, want.rel_res)
    assert cg_ == ce and cg_["launches"]
    # the first iteration eager, then one capture and a replay for every
    # other iteration, and at most IN_FLIGHT done-gated ones past the count
    assert stats["captures"] == 1
    assert its - 1 <= stats["replays"] <= its - 1 + graphs.IN_FLIGHT


def test_graph_serves_every_refinement_round(cuda):
    """One capture for the solve; each round's tolerance enters as a
    tensor, so the rounds' different eps reach the graph."""
    from openimpala_tpu_torch.solve.cg import ResidualHistory
    from openimpala_tpu_torch.solve.refine import solve_system
    from openimpala_tpu_torch.utils import graphs

    s = _blob_system(cuda, 48)
    x0 = torch.zeros_like(s.r0_b)

    def run():
        hist = ResidualHistory()
        x, info = solve_system(s, x0, eps=1e-11, maxiter=5000,
                               precond="gmg", history=hist)
        return x, info, hist

    (xg, ig, hg), (xe, ie, he), cg_, ce, stats = _twin(run)
    assert torch.equal(xg, xe) and ig.iterations == ie.iterations
    assert ig.rel_res == ie.rel_res and hg.inner == he.inner
    assert hg.outer == he.outer and len(hg.outer) >= 3  # several rounds
    assert cg_ == ce
    assert stats["captures"] == 1 and stats["calls"] >= 2
    # each round stops at its count, with at most IN_FLIGHT steps past it
    assert ig.iterations <= stats["captures"] + stats["replays"] <= \
        ig.iterations + graphs.IN_FLIGHT * stats["calls"]


def test_graphed_lanes_equal_eager(cuda):
    from openimpala_tpu_torch.solve.lanes import (LaneSystem,
                                                  solve_system_lanes)
    from openimpala_tpu_torch.utils import graphs

    from openimpala_tpu_torch.utils.sample_data import make_blobs

    active = torch.from_numpy(make_blobs(32, 0.4, 0) == 1).to(cuda)
    lsys = LaneSystem.from_systems([
        st.make_cell_problem_system(active, k, dtype=torch.float32)
        for k in range(3)])
    (xg, ig), (xe, ie), cg_, ce, stats = _twin(
        lambda: solve_system_lanes(lsys, 1e-9, 5000, precond="gmg"))
    assert torch.equal(xg, xe)
    assert ig.iterations == ie.iterations and ig.rel_res == ie.rel_res
    assert cg_ == ce and stats["captures"] == 1
    # the largest lane count of each round, at most IN_FLIGHT steps past
    assert stats["reads"] <= stats["captures"] + stats["replays"] <= \
        stats["reads"] + graphs.IN_FLIGHT * stats["calls"]


def test_graphed_batched_equals_eager(cuda):
    from openimpala_tpu_torch.solve.batched import batched_cell_problems
    from openimpala_tpu_torch.utils import graphs

    masks = torch.from_numpy(np.random.default_rng(0).random(
        (6, 16, 16, 16)) < 0.7).to(cuda)
    (cg_chi, cg_rel, cg_ok), (ce_chi, ce_rel, ce_ok), cg_, ce, stats = _twin(
        lambda: batched_cell_problems(masks, 1, 1e-9, 5000))
    assert torch.equal(cg_chi, ce_chi) and torch.equal(cg_rel, ce_rel)
    assert bool(cg_ok.all()) and torch.equal(cg_ok, ce_ok)
    assert cg_ == ce and stats["captures"] == 1
    assert stats["reads"] <= stats["captures"] + stats["replays"] <= \
        stats["reads"] + graphs.IN_FLIGHT * stats["calls"]


def test_graphed_direct_equals_eager_and_cpu(cuda):
    from openimpala_tpu_torch import tortuosity_direct
    from openimpala_tpu_torch.utils.sample_data import make_blobs

    vol = make_blobs(16, 0.6, 0)
    got, want, _, _, stats = _twin(lambda: tortuosity_direct(
        vol, 1, "X", return_fields=True))
    assert got.value == want.value and got.iterations == want.iterations
    assert torch.equal(got.phi, want.phi) and got.residual == want.residual
    assert stats["captures"] == 1
    cpu = tortuosity_direct(vol, 1, "X", device="cpu")
    assert got.iterations == cpu.iterations == 5151
    assert abs(got.value - cpu.value) <= 1e-9 * abs(cpu.value)


@pytest.mark.parametrize("entry", ["tau", "tau-sa", "deff", "deff-seq",
                                   "rev"])
def test_entry_points_graphed_equal_eager(cuda, entry):
    from openimpala_tpu_torch.utils.sample_data import make_blobs

    vol = make_blobs(32, 0.4, 0)
    if entry.startswith("tau"):
        pre = "sa" if entry == "tau-sa" else "auto"
        g, e, cg_, ce, _ = _twin(lambda: tortuosity(vol, 1, "X",
                                                    precond=pre))
        assert (g.value, g.iterations, g.rel_res) == \
            (e.value, e.iterations, e.rel_res)
    elif entry.startswith("deff"):
        lanes = entry == "deff"
        g, e, cg_, ce, _ = _twin(lambda: effective_diffusivity(
            vol, 1, lanes=lanes))
        assert g.lanes == lanes
        np.testing.assert_array_equal(g.deff, e.deff)
        assert g.iterations == e.iterations
    else:
        g, e, cg_, ce, _ = _twin(lambda: rev_study(
            vol, 1, sizes=(16,), num_samples=8, eps=1e-9))
        for a, b in zip(g, e):
            np.testing.assert_array_equal(a.deff, b.deff)
    assert cg_ == ce and cg_["launches"] and not cg_["plain_on_cuda"]


def test_replay_adds_the_captured_counts(cuda):
    """A replayed step adds exactly what its capture counted, once per
    replay; the capture itself adds nothing."""
    from openimpala_tpu_torch.utils import graphs

    x = torch.rand((8, 12, 10), device=cuda)
    free = x > 0.2
    w, per = (1.0, 1.0, 1.0), (False, True, False)

    def step(x, dot, diag):
        y, d = sc.k4_matvec(x, diag, free, w, per, with_dot=True)
        z = sc.k1_stencil("matvec", y, None,
                          torch.zeros_like(y, dtype=torch.bfloat16), w, per)
        x.add_(z * 1e-3)
        dot.copy_(d)

    def tail(x, dot, diag):
        return (dot * 2,)

    h = graphs.ChunkGraph()
    h.load("t", step, tail, (x, torch.zeros((), device=cuda)),
           (torch.full((), 6.0, device=cuda),))
    sc.reset_counts()
    h.run()  # eager, then the capture
    one = _counts()
    assert one["launches"] == {"k4_matvec_dot_f32": 1, "k1_matvec_f32": 1}
    h.run()  # a replay
    assert {k: dict(v) for k, v in h.graphs["step"][2].items()} == one
    assert _counts()["launches"] == {"k4_matvec_dot_f32": 2,
                                     "k1_matvec_f32": 2}
    (got,) = h.run(3)
    c = _counts()
    assert c["launches"] == {"k4_matvec_dot_f32": 5, "k1_matvec_f32": 5}
    assert sum(c["launches_route_at"].values()) == 5
    # the state advanced once per step, as eagerly
    ref, dot = x.clone(), torch.zeros((), device=cuda)
    for _ in range(5):
        step(ref, dot, torch.full((), 6.0, device=cuda))
    torch.testing.assert_close(h.state[0], ref, rtol=0, atol=0)
    torch.testing.assert_close(got, dot * 2, rtol=0, atol=0)
    h.close()


def test_pipelined_probe_reads_every_step(cuda):
    """``advance`` enqueues a step and its probe's copy into a pinned
    slot; ``read`` returns that step's probe while later steps are in
    flight, and refuses a ticket whose slot a later step has taken."""
    from openimpala_tpu_torch.utils import graphs

    def step(x, k):
        x.add_(k)

    def tail(x, k):
        return (torch.stack([x.sum(), x[0]]),)

    h = graphs.ChunkGraph()
    h.load("p", step, tail, (torch.zeros(4, device=cuda),),
           (torch.ones((), device=cuda),))
    slots = graphs.IN_FLIGHT + 1
    tickets = [h.advance() for _ in range(slots)]
    assert tickets == list(range(slots))
    for k in range(20):
        assert h.read(k) == [4.0 * (k + 1), k + 1.0]
        h.advance()
    assert all(s.is_pinned() for s in h.slots)
    with pytest.raises(ValueError):
        h.read(h.issued - slots - 1)
    h.close()
    assert h.buffers is None and not h.graphs and not h.slots


def test_capture_releases_dead_pools(cuda):
    """Closed graphs leave their pools reserved until the cache is
    emptied, which a capture cannot do: holders whose captures need more
    than the card has left still capture (the capture that runs out of
    memory empties the cache and tries again), and compute the same."""
    from openimpala_tpu_torch.utils import graphs

    torch.cuda.empty_cache()
    n = int(torch.cuda.mem_get_info()[0] * 0.3) // 4

    def step(x):
        big = torch.ones(n, device=cuda)  # a temporary in the graph's pool
        x.add_(big[:4])

    def tail(x):
        return (x.sum(),)

    sums = []
    for _ in range(4):  # four pools of 0.3 of the card's free memory
        h = graphs.ChunkGraph()
        h.load("big", step, tail, (torch.zeros(4, device=cuda),), ())
        (total,) = h.run(3)
        sums.append(float(total))
        h.close()
    assert sums == [12.0] * 4
    torch.cuda.empty_cache()


def test_warmup_on_card(cuda, monkeypatch):
    """A handle builds and loads the configuration's kernels; its launches
    add to no counter; ``warm=`` changes no result; once the kernels are
    loaded no thread starts."""
    from openimpala_tpu_torch.props import prime_cell_solver, prime_solver
    from openimpala_tpu_torch.utils.sample_data import make_blobs

    vol = make_blobs(32, 0.4, 0)
    monkeypatch.setattr(sc, "_libs", {})  # as in a new process
    sc.reset_counts()
    h = prime_solver(vol.shape, "X", precond="sa")
    assert h is not None
    h.join()
    assert h.timing["kernels"] == ["k1", "k3"] and not sc.launches
    assert tortuosity(vol, 1, "X", precond="sa", warm=h).value == \
        tortuosity(vol, 1, "X", precond="sa").value
    sc.reset_counts()
    h = prime_cell_solver(vol.shape, precond="cheby")
    h.join()
    assert h.timing["kernels"] == ["k1", "k4", "k5"] and not sc.launches
    assert h.timing["built"] == ["k4", "k5"]  # k1 was loaded already
    assert prime_solver(vol.shape, "X", precond="sa") is None


def test_failed_capture_raises(cuda):
    """A body that reads the device on the host cannot be captured."""
    from openimpala_tpu_torch.utils import graphs

    h = graphs.ChunkGraph()

    def step(x):
        x.add_(float(x.sum()))

    h.load("bad", step, lambda x: (x,), (torch.ones(4, device=cuda),), ())
    sc.reset_counts()
    with pytest.raises(RuntimeError):
        h.run()  # the eager step, then the capture that fails
    assert not h.graphs and not sc.launches
    torch.cuda.synchronize()


@pytest.mark.parametrize("shape,dx", [((12, 18, 16), (1.0, 1.0, 1.0)),
                                      ((16, 8, 256), (1.0, 1.0, 2.0))])
def test_k1_on_the_slab_layout_matches_plain(cuda, shape, dx):
    """K1 on a slab in ``ops/stencil.py``'s slab layout (two planes of -1
    code on each side of X, ghosts from the slab's own clamp) against the
    plain forms; ``restrict`` pairs the padded planes, so the slab's own
    pairs come out between two planes of 0."""
    s = _system("flow", shape, dx, torch.float32, cuda)
    code = st.code_slab(s.code)
    per = st.slab_periodic(s.periodic)
    g = torch.Generator(device=cuda).manual_seed(3)
    xp = st.pad_slab(torch.randn(shape, generator=g, device=cuda))
    rp = st.pad_slab(torch.randn(shape, generator=g, device=cuda),
                     ghosts=False)
    for mode, plain in (
            ("matvec", lambda: st.apply_code_plain(xp, code, s.w, per)),
            ("sweep", lambda: st.smooth_sweep_plain(xp, rp, code, s.w, per,
                                                    0.9)),
            ("resid", lambda: st.residual_restricted_plain(xp, rp, code,
                                                           s.w, per)),
            ("restrict", lambda: st.residual_restrict_plain(xp, rp, code,
                                                            s.w, per))):
        got = sc.k1_stencil(mode, xp, None if mode == "matvec" else rp,
                            code, s.w, per, omega=0.9)
        torch.testing.assert_close(got, plain(), **TOL[torch.float32])
    out = sc.k1_stencil("restrict", xp, rp, code, s.w, per)
    assert (out[0] == 0).all() and (out[-1] == 0).all()
    # the slab's own pairs: the single-volume restrict of the slab
    want = st.residual_restrict_plain(
        xp[2:-2].contiguous(), rp[2:-2].contiguous(), s.code, s.w,
        s.periodic)
    torch.testing.assert_close(out[1:-1], want, **TOL[torch.float32])


@pytest.mark.parametrize("mode", ["sweep", "resid"])
def test_k1_stream_periodic_repeats_under_allocation_churn(cuda, mode):
    """K1's stream route on a 512^3 periodic cell problem gives the same
    bits launch after launch while another thread maps and unmaps device
    memory: without the proxy fence in the ring's release, about one
    launch in a hundred had one warp's row of one plane wrong."""
    import threading

    s = _system("cell", (512, 512, 512), (1.0, 1.0, 1.0), torch.float32,
                cuda)
    assert sc.k1_route(tuple(s.code.shape), torch.float32,
                       s.periodic) == "stream"
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(tuple(s.code.shape), generator=gen, device=cuda)
    r = torch.randn(tuple(s.code.shape), generator=gen, device=cuda)

    def k1():
        return sc.k1_stencil(mode, x, r, s.code, s.w, s.periodic)

    ref = k1().clone()
    stop = threading.Event()

    def churn():
        while not stop.is_set():
            a = torch.empty(1 << 28, device=cuda)
            del a
            torch.cuda.empty_cache()

    thread = threading.Thread(target=churn)
    thread.start()
    try:
        bad = sum(not torch.equal(k1(), ref) for _ in range(400))
    finally:
        stop.set()
        thread.join()
    assert bad == 0


# ---------------------------------------------------------------------------
# The coarsest level's Chebyshev solve: one K2 cheby launch per step
# ---------------------------------------------------------------------------


def _cheby_unfused(lvl, x, r, degree, ratio):
    """The Chebyshev iteration as K2 matvec and PyTorch's elementwise
    kernels: the sequence that K2's cheby modes fuse."""
    hi = 2.2
    lo = hi / ratio
    theta, delta = 0.5 * (hi + lo), 0.5 * (hi - lo)
    sigma = theta / delta
    ft = {torch.float32: np.float32, torch.float64: np.float64}[r.dtype]
    diag, free = lvl.diag.to(r.dtype), lvl.free
    inv_d = torch.where(free & (diag > 0),
                        1.0 / torch.where(diag > 0, diag, 1.0),
                        torch.zeros((), dtype=r.dtype, device=r.device))
    x = torch.zeros_like(r) if x is None else x
    res = r - lvl.apply(x)
    d = inv_d * res * float(ft(1.0 / theta))
    x = x + d
    two_sigma, two_over_delta = ft(2.0 * sigma), ft(2.0 / delta)
    rho = ft(1.0 / sigma)
    for _ in range(1, degree):
        res = res - lvl.apply(d)
        rho_new = ft(1.0) / (two_sigma - rho)
        d = (float(rho_new * rho) * d
             + float(rho_new * two_over_delta) * (inv_d * res))
        x = x + d
        rho = rho_new
    return x


def _cheby_level(cuda, which, kind, dtype):
    """A conductance level and the cycle that owns it: the fine
    conductances of a 128^3 or an odd 33x21x17 system (blocked cells among
    them), or the coarsest Galerkin level of the 128^3 system (32^3)."""
    shape = (33, 21, 17) if which == "odd" else (128, 128, 128)
    s = _system(kind, shape, (1.0, 1.0, 1.0), dtype, cuda)
    M = GalerkinMGPreconditioner.from_system(s)
    if which == "32":
        return M, M.levels[-1]
    lvl = fine_conductances(s)
    assert bool((lvl.diag == 0).any())
    return M, lvl


@pytest.mark.parametrize("graphed", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["flow", "cell"])
@pytest.mark.parametrize("which", ["128", "32", "odd"])
def test_fused_coarse_solve_equals_unfused(cuda, which, kind, dtype,
                                           graphed):
    """The Chebyshev iteration on a conductance level, one K2 cheby launch
    a step, equals K2 matvec and the elementwise kernels to the bit
    (clamped and periodic, float32 and float64), from zero and from a
    nonzero start, eagerly and replayed from a CUDA graph."""
    M, lvl = _cheby_level(cuda, which, kind, dtype)
    shape = tuple(lvl.diag.shape)
    kw = {}
    GalerkinMGPreconditioner._coarse_defaults(kw, shape)
    degree, ratio = kw["coarse_sweeps"], kw["coarse_ratio"]
    g = torch.Generator(device=cuda).manual_seed(3)
    r = torch.where(lvl.free, torch.randn(shape, generator=g, dtype=dtype,
                                          device=cuda), 0.0)
    x0 = torch.randn(shape, generator=g, dtype=dtype, device=cuda)
    diag = lvl.diag.to(dtype)

    def fused():
        return (M._smooth_cheby(lvl, diag, lvl.free, None, r, degree, ratio),
                M._smooth_cheby(lvl, diag, lvl.free, x0, r, degree, ratio))

    sc.reset_counts()
    if graphed:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fused()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fused()
        r.copy_(torch.where(lvl.free, torch.randn(
            shape, generator=g, dtype=dtype, device=cuda), 0.0))
        graph.replay()
        torch.cuda.synchronize()
    else:
        out = fused()
    tag = "f32" if dtype == torch.float32 else "f64"
    assert sc.launches[f"k2_cheby_{tag}"] == 2 * (degree - 1) * (
        2 if graphed else 1)
    assert sc.launches[f"k2_cheby_init_{tag}"] == (2 if graphed else 1)
    want0 = _cheby_unfused(lvl, None, r, degree, ratio)
    want1 = _cheby_unfused(lvl, x0, r, degree, ratio)
    assert torch.equal(out[0], want0)
    assert torch.equal(out[1], want1)
    assert not sc.plain_on_cuda
    if graphed:
        del graph


def test_vcycle_at_512_runs_the_coarse_solve_fused(cuda):
    """One V-cycle of the default cycle at 512^3 (coarsest 128^3, 102
    Chebyshev steps): the zero-start step and 101 K2 cheby launches at the
    coarsest extent, no K2 matvec there."""
    s = _system("flow", (512, 512, 512), (1.0, 1.0, 1.0), torch.float32,
                cuda)
    M = GalerkinMGPreconditioner.from_system(s)
    coarsest = (128, 128, 128)
    assert tuple(M.levels[-1].diag.shape) == coarsest
    assert M.coarse_sweeps == 102
    g = torch.Generator(device=cuda).manual_seed(4)
    r = torch.where(s.free, torch.randn(s.free.shape, generator=g,
                                        device=cuda), 0.0)
    sc.reset_counts()
    z = M(r)
    torch.cuda.synchronize()
    at = sc.launches_at
    assert at["k2_cheby_f32", coarsest] == 101
    assert at["k2_cheby_init_f32", coarsest] == 1
    assert at.get(("k2_matvec_f32", coarsest), 0) == 0
    assert sum(v for (k, _), v in at.items() if k == "k2_cheby_f32") == 101
    assert not sc.plain_on_cuda and bool(torch.isfinite(z).all())


@pytest.mark.parametrize("opts", [{}, {"smoother": "cheby"}])
def test_slab_gathered_coarse_solve_on_card(cuda, opts):
    """The slab cycle on two ranks of one card (gloo), gathered at the
    coarsest level, where every rank runs the fused Chebyshev solve on
    the global level: equal to the single-card cycle to 1e-10 in float64,
    with the default and the Chebyshev smoother."""
    from openimpala_tpu_torch.parallel import spawn

    shape = (32, 16, 16)
    rng = np.random.default_rng(9)
    active = rng.random(shape) < 0.7
    sys1 = st.make_tortuosity_system(torch.from_numpy(active).to(cuda), 0,
                                     -1.0, 1.0, dtype=torch.float64)
    r = np.where(active, rng.standard_normal(shape), 0.0)
    M = GalerkinMGPreconditioner.from_system(sys1, **opts)
    sc.reset_counts()
    z1 = M(torch.from_numpy(r).to(cuda)).cpu().numpy()
    assert sc.launches["k2_cheby_f64"] > 0
    got = spawn.run("openimpala_tpu_torch.parallel.checks:vcycle", 2,
                    args=(active, r, 0, (1.0, 1.0, 1.0), opts),
                    device="cuda:0", timeout=300)
    assert [gl for _, gl in got] == [len(M.levels)] * 2
    z = np.concatenate([zs for zs, _ in got])
    np.testing.assert_allclose(z, z1, rtol=0, atol=1e-10)


def test_slab_coarse_solve_on_slabs_on_card(cuda):
    """The slab cycle on two ranks of one card (gloo) with the coarsest
    level's Chebyshev solve on the slabs (``SLAB_COARSE_MIN_CELLS`` set to
    0 on the ranks): equal to the single-card cycle to 1e-10 in float64;
    each rank launches K2's cheby step ``coarse_sweeps - 1`` times and its
    zero-start step once at the padded slab's extent, and none at the
    global coarsest extent, with one ghost exchange a step and no plain
    form on a CUDA tensor."""
    from openimpala_tpu_torch.parallel import spawn

    shape = (32, 16, 16)
    rng = np.random.default_rng(9)
    active = rng.random(shape) < 0.7
    sys1 = st.make_tortuosity_system(torch.from_numpy(active).to(cuda), 0,
                                     -1.0, 1.0, dtype=torch.float64)
    r = np.where(active, rng.standard_normal(shape), 0.0)
    M = GalerkinMGPreconditioner.from_system(sys1)
    z1 = M(torch.from_numpy(r).to(cuda)).cpu().numpy()
    glob = tuple(int(v) for v in M.levels[-1].diag.shape)
    slab = (glob[0] // 2 + 2,) + glob[1:]
    got = spawn.run(
        "openimpala_tpu_torch.parallel.checks:with_constants", 2,
        args=({"openimpala_tpu_torch.solve.slab_mg:SLAB_COARSE_MIN_CELLS":
               0}, "vcycle", (active, r, 0, (1.0, 1.0, 1.0), {})),
        device="cuda:0", timeout=300)
    assert [gl for (_, gl), _ in got] == [None] * 2
    for _, counts in got:
        at = counts["launches_at"]
        assert at[("k2_cheby_f64", slab)] == M.coarse_sweeps - 1
        assert at[("k2_cheby_init_f64", slab)] == 1
        assert not any(s == glob for (_, s) in at)
        assert counts["mesh"]["coarse_slab_exchanges"] == (
            M.coarse_sweeps - 1)
        assert not counts["plain_on_cuda"]
    z = np.concatenate([zs for (zs, _), _ in got])
    np.testing.assert_allclose(z, z1, rtol=0, atol=1e-10)


def test_cli_thresholds_tiff_stack_on_card(cuda, tmp_path, monkeypatch):
    """``TiffReader.threshold_tensor`` on the card equals the host's
    ``threshold`` (1 bit in both FillOrders, 16-bit samples; NaN and swapped
    values); the CLI on a 1-bit stack writes the same ``results.txt``
    whether the card thresholded it or the host did, and its request
    counts the stack's pages in ``device_pages``, then none."""
    from openimpala_tpu_torch import diffusion
    from openimpala_tpu_torch.io.tiff import TiffReader
    from openimpala_tpu_torch.io.tiff_raw import write_tiff
    from openimpala_tpu_torch.utils import profiling
    from openimpala_tpu_torch.utils.sample_data import make_blobs

    vol = make_blobs(24, 0.4, 4)[:21, :, :12]  # 21 x 24 x 12
    pages = [vol[:, :, z].T.astype(bool) for z in range(vol.shape[2])]
    rng = np.random.default_rng(3)
    for name, stack, fill_order in (
            ("fo1.tif", pages, 1), ("fo2.tif", pages, 2),
            ("u16.tif", [rng.integers(0, 300, (24, 21)).astype(np.uint16)
                         for _ in range(12)], 1)):
        write_tiff(str(tmp_path / name), stack, fill_order=fill_order)
        reader = TiffReader(str(tmp_path / name))
        for thr, vtrue, vfalse in ((0.5, 1, 0), (127, 0, 1),
                                   (float("nan"), 1, 0)):
            got = reader.threshold_tensor(thr, vtrue, vfalse, cuda)
            assert got.device.type == "cuda" and got.dtype == torch.int8
            np.testing.assert_array_equal(
                got.cpu().numpy(), reader.threshold(thr, vtrue, vfalse))

    res = tmp_path / "results"
    (tmp_path / "run.inputs").write_text(
        f"filename = fo1.tif\ndata_path = {tmp_path}/\n"
        f"results_path = {res}/\nphase_id = 1\nhypre.eps = 1e-9\n"
        "calculation_method = flow_through\ndirection = All\n")
    monkeypatch.setattr(profiling, "_ENABLED", True)
    texts, counted = [], []
    try:
        for host in (False, True):
            if host:
                monkeypatch.setattr(TiffReader, "threshold_tensor",
                                    lambda *args, **kwargs: None)
            assert diffusion.main([str(tmp_path / "run.inputs")]) == 0
            texts.append((res / "results.txt").read_text())
            counted.append(profiling.requests[-1]["counters"]["device_pages"])
    finally:
        profiling.reset()
    assert texts[0] == texts[1] and "Tortuosity_Z" in texts[0]
    assert counted == [12, 0]
