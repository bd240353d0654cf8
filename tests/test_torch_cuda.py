"""PyTorch port on the card: kernels K1, K2 and K3 against their plain
PyTorch versions at small shapes, and the slice on the GPU against the CPU.

Marked ``cuda``; each test skips without a CUDA device.  Imports no JAX, so
it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from openimpala_tpu_torch import tortuosity  # noqa: E402
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
