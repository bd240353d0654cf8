"""PyTorch port: small modules against the JAX package on the same inputs,
the import and device rules, and the kernel wrappers' input checks."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from openimpala_tpu.ops import filters as j_filters  # noqa: E402
from openimpala_tpu.ops import floodfill as j_floodfill  # noqa: E402
from openimpala_tpu.ops import flux as j_flux  # noqa: E402
from openimpala_tpu.ops import masks as j_masks  # noqa: E402
from openimpala_tpu.parallel.halo import pad_halo as j_pad_halo  # noqa: E402
from openimpala_tpu.props.volume_fraction import (  # noqa: E402
    volume_fraction as j_volume_fraction)
from openimpala_tpu_torch import convert  # noqa: E402
from openimpala_tpu_torch.ops import (  # noqa: E402
    filters, floodfill, flux, masks)
from openimpala_tpu_torch.ops import stencil, stencil_cuda  # noqa: E402
from openimpala_tpu_torch.parallel.halo import pad_halo  # noqa: E402
from openimpala_tpu_torch.props.volume_fraction import (  # noqa: E402
    volume_fraction)
from openimpala_tpu_torch.utils.common import (  # noqa: E402
    direction_name, parse_direction, resolve_device)

REPO = Path(__file__).resolve().parent.parent


def test_direction_helpers():
    assert [parse_direction(d) for d in ("x", " Y", "Z", 2)] == [0, 1, 2, 2]
    assert [direction_name(d) for d in range(3)] == ["X", "Y", "Z"]


@pytest.mark.parametrize("periodic", [(False, False, False),
                                      (True, False, True),
                                      (True, True, True)])
def test_pad_halo_matches_jax(periodic):
    x = np.random.default_rng(0).standard_normal((4, 3, 5))
    want = np.asarray(j_pad_halo(jnp.asarray(x), periodic))
    got = pad_halo(torch.from_numpy(x), periodic).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("direction", [0, 1, 2])
def test_linear_ramp_matches_jax(direction):
    shape = (5, 4, 3)
    want = np.asarray(j_masks.linear_ramp(shape, direction, -1.0, 1.0,
                                          dtype=jnp.float64))
    got = masks.linear_ramp(shape, direction, -1.0, 1.0,
                            dtype=torch.float64).numpy()
    np.testing.assert_array_equal(got, want)
    one = masks.linear_ramp((1, 2, 2), 0, -1.0, 1.0, dtype=torch.float64)
    assert float(one[0, 0, 0]) == 0.0


def test_phase_mask_and_remspot_match_jax(blob_phase):
    p = blob_phase.copy()
    p[5, 5, 5] = 1 - p[5, 5, 5]  # likely isolated voxels
    np.testing.assert_array_equal(
        masks.phase_mask(torch.from_numpy(p), 1).numpy(),
        np.asarray(j_masks.phase_mask(jnp.asarray(p), 1)))
    for passes in (1, 2):
        want = np.asarray(j_filters.remspot(jnp.asarray(p), passes))
        got = filters.remspot(torch.from_numpy(p), passes).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("direction", [0, 1, 2])
def test_percolation_mask_bit_exact(blob_phase, direction):
    vol = np.random.default_rng(3).random((24, 20, 18)) < 0.45
    for phase in (blob_phase, vol.astype(np.uint8)):
        want, want_vf = j_floodfill.percolation_mask(phase, 1, direction,
                                                     method="host")
        got, got_vf = floodfill.percolation_mask(phase, 1, direction)
        np.testing.assert_array_equal(got, np.asarray(want))
        assert got_vf == want_vf
        rin, rout = floodfill.flood_fill_host(phase == 1, direction)
        jin, jout = j_floodfill.flood_fill_host(phase == 1, direction)
        np.testing.assert_array_equal(rin, jin)
        np.testing.assert_array_equal(rout, jout)


def test_percolation_empty_face_and_methods():
    phase = np.ones((6, 6, 6), np.int32)
    phase[0] = 0
    active, vf = floodfill.percolation_mask(phase, 1, 0)
    assert vf == 0.0 and not active.any()
    # every method gives the empty mask; "auto" on the CPU is the host
    for method in ("host", "native", "device", "auto"):
        active, vf = floodfill.percolation_mask(phase, 1, 0, method=method,
                                                device="cpu")
        assert vf == 0.0 and not np.asarray(active).any()
        assert isinstance(active, torch.Tensor) == (method == "device")
    with pytest.raises(ValueError, match="unknown percolation method"):
        floodfill.percolation_mask(phase, 1, 0, method="raster")


@pytest.mark.parametrize("direction", [0, 1, 2])
def test_boundary_fluxes_match_jax(direction):
    rng = np.random.default_rng(direction)
    phi = rng.standard_normal((7, 6, 5))
    active = rng.random((7, 6, 5)) < 0.7
    dx = (1.0, 0.5, 2.0)
    want = j_flux.boundary_fluxes(jnp.asarray(phi), jnp.asarray(active),
                                  direction, dx)
    got = flux.boundary_fluxes(torch.from_numpy(phi),
                               torch.from_numpy(active), direction, dx)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-12,
                                   atol=1e-12)
    assert (flux.active_boundary_counts(torch.from_numpy(active), direction)
            == j_flux.active_boundary_counts(jnp.asarray(active), direction))


def test_volume_fraction_matches_jax(blob_phase):
    assert volume_fraction(blob_phase, 1, device="cpu") == \
        j_volume_fraction(blob_phase, 1)


def test_import_leaves_jax_out():
    code = ("import sys, openimpala_tpu_torch; "
            "import openimpala_tpu_torch.diffusion, openimpala_tpu_torch.config; "
            "import openimpala_tpu_torch.io.native; "
            "import openimpala_tpu_torch.solve.fgmres; "
            "import openimpala_tpu_torch.solve.warmup; "
            "import openimpala_tpu_torch.utils.graphs; "
            "import openimpala_tpu_torch.utils.profiling; "
            "import openimpala_tpu_torch.props.tortuosity_direct; "
            "import openimpala_tpu_torch.parallel.checks; "
            "import openimpala_tpu_torch.parallel.spawn; "
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'openimpala_tpu.'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.stdout.strip() == "[]"


def _imported_modules(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_imports_in_port_or_chip_smoke():
    files = sorted((REPO / "openimpala_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "openimpala_tpu"), \
                f"{path.relative_to(REPO)} imports {mod}"


@pytest.mark.parametrize("n,porosity,seed", [(16, 0.4, 0), (21, 0.3, 5)])
def test_make_blobs_matches_sample_data_recipe(n, porosity, seed):
    from openimpala_tpu_torch.utils.sample_data import make_blobs

    sys.path.insert(0, str(REPO / "scripts"))
    try:
        from make_sample_data import make_blobs as script_make_blobs
    finally:
        sys.path.remove(str(REPO / "scripts"))
    np.testing.assert_array_equal(make_blobs(n, porosity, seed),
                                  script_make_blobs(n, porosity, seed))


def test_chip_smoke_refuses_without_cuda():
    code = ("import sys, torch; torch.cuda.is_available = lambda: False; "
            "sys.argv = ['chip_smoke.py']; import chip_smoke; "
            "sys.exit(chip_smoke.main())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_device_rule(monkeypatch, blob_phase):
    import openimpala_tpu_torch as oit

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        oit.tortuosity(blob_phase, 1, "X")
    with pytest.raises(RuntimeError, match="CUDA"):
        oit.volume_fraction(blob_phase, 1)
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros((4, 4, 4), dtype=torch.float32)
    code = torch.zeros((4, 4, 4), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        stencil_cuda.k1_stencil("matvec", x, None, code, (1.0,) * 3,
                                (False,) * 3)
    with pytest.raises(ValueError, match="CUDA"):
        stencil_cuda.k2_conductance("matvec", x, None, x, x, x, x)
    with pytest.raises(ValueError, match="mode"):
        stencil_cuda.k1_stencil("bogus", x, None, code, (1.0,) * 3,
                                (False,) * 3)
    # a device that is neither the CPU nor CUDA goes to the kernel and raises
    meta = torch.zeros((4, 4, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        stencil.apply_code(meta, code.to("meta"), (1.0,) * 3, (False,) * 3)


def test_k2_cheby_wrappers_refuse_cpu_tensors():
    """The Chebyshev step's kernel takes CUDA tensors only; a CPU level
    runs its plain step (``ConductanceLevel.cheby_step_plain``)."""
    x = torch.zeros((4, 4, 4), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        stencil_cuda.k2_cheby(x, x.clone(), x.clone(), x, x, x, x, 1.0, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        stencil_cuda.k2_cheby_init(x, x, 1.0)


def test_plain_forms_count_only_cuda_tensors():
    stencil_cuda.reset_counts()
    x = torch.zeros((4, 4, 4), dtype=torch.float64)
    code = torch.full((4, 4, 4), 6.0, dtype=torch.bfloat16)
    stencil.apply_code(x, code, (1.0,) * 3, (True,) * 3)
    assert not stencil_cuda.plain_on_cuda and not stencil_cuda.launches


def test_convert_bf16_code_roundtrip():
    from openimpala_tpu.ops.stencil import make_tortuosity_system as j_make

    mask = np.random.default_rng(5).random((6, 5, 4)) < 0.7
    js = j_make(jnp.asarray(mask), 1, -1.0, 1.0, dx=(1.0, 0.5, 2.0))
    ps = convert.system_from_numpy(np.asarray(js.code),
                                   np.asarray(js.x_forced),
                                   np.asarray(js.r0_b), np.asarray(js.b_norm),
                                   js.w, js.periodic, device="cpu")
    assert ps.code.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        ps.code.view(torch.int16).numpy().view(np.uint16),
        np.asarray(js.code).view(np.uint16))
    assert float(ps.b_norm) == float(js.b_norm)
