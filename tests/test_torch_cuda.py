"""PyTorch port on the card: kernels K1 and K2 against their plain PyTorch
versions at small shapes, and the slice on the GPU against the CPU.

Marked ``cuda``; each test skips without a CUDA device.  Imports no JAX, so
it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from openimpala_tpu_torch import tortuosity  # noqa: E402
from openimpala_tpu_torch.ops import stencil as st  # noqa: E402
from openimpala_tpu_torch.ops import stencil_cuda as sc  # noqa: E402
from openimpala_tpu_torch.solve.preconditioners import (  # noqa: E402
    GalerkinMGPreconditioner, fine_conductances)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
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


def test_tortuosity_gpu_matches_cpu(cuda):
    vol = (np.random.default_rng(7).random((20, 18, 16)) < 0.65).astype(
        np.int32)
    sc.reset_counts()
    gpu = tortuosity(vol, 1, "Y", device=cuda)
    assert sc.launches["k1_matvec_dot_f32"] >= gpu.iterations
    assert not sc.plain_on_cuda
    cpu = tortuosity(vol, 1, "Y", device="cpu")
    assert abs(gpu.value - cpu.value) <= 1e-6 * abs(cpu.value)
    assert gpu.active_vf == cpu.active_vf
    assert abs(gpu.iterations - cpu.iterations) <= 1
