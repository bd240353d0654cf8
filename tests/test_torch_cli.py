"""PyTorch port, the host surface against the JAX package: the readers
(each returns the JAX reader's array on the same file), the config
(``ParmParse``, ``DiffusionConfig``, the solver map), the native binding,
and the port's CLI, ``python -m openimpala_tpu_torch.diffusion``, run
in-process with ``device=cpu``: its ``results.txt`` against the JAX
package's ``write_results_txt`` over ``openimpala_tpu.tortuosity`` on the
same thresholded phase (numbers to 1e-6, every other line equal).

The JAX CLI itself is not run in-process here: under this suite's eight
virtual CPU devices it takes the sharded ingest path."""

import dataclasses
import struct
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

import openimpala_tpu as oi  # noqa: E402
from openimpala_tpu import config as j_config  # noqa: E402
from openimpala_tpu.io import native as j_native  # noqa: E402
from openimpala_tpu.io import writers as j_writers  # noqa: E402
from openimpala_tpu.io.raw import RawDataType  # noqa: E402
from openimpala_tpu.io.tiff_raw import write_tiff  # noqa: E402
from openimpala_tpu.props.volume_fraction import (  # noqa: E402
    volume_fraction_counts)
from openimpala_tpu_torch import config as p_config  # noqa: E402
from openimpala_tpu_torch import diffusion  # noqa: E402
from openimpala_tpu_torch.io import native as p_native  # noqa: E402
from openimpala_tpu_torch.io import writers as p_writers  # noqa: E402
from openimpala_tpu_torch.io.tiff import TiffReader  # noqa: E402
from openimpala_tpu_torch.utils import profiling  # noqa: E402
from portbench.kinds.cli import write_tiff1  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))
import make_sample_data as msd  # noqa: E402

N = 16  # edge of the sample volume


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    """``scripts/make_sample_data.py``'s formats of one 16^3 volume."""
    d = tmp_path_factory.mktemp("sample")
    vol = msd.make_blobs(N, 0.4, 0)
    msd.write_tiff_1bit(str(d / "stack_1bit.tif"), vol)
    msd.write_raw(str(d / "vol_uint8.raw"), vol)
    msd.write_dat(str(d / "vol.dat"), vol)
    msd.write_tiff_sequence(str(d), "seq", vol)
    if _has("h5py"):
        msd.write_hdf5(str(d / "vol.hdf5"), vol)
    return d, vol


def _has(mod):
    try:
        __import__(mod)
        return True
    except ImportError:
        return False


def _both(path, **kw):
    return (j_writers.read_any(str(path), **kw),
            p_writers.read_any(str(path), **kw))


def _same_reader(jr, pr, thr=0.5):
    assert type(pr).__name__ == type(jr).__name__
    assert pr.shape == jr.shape and pr.box() == jr.box()
    want, got = jr.read(), pr.read()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    want_t, got_t = jr.threshold(thr, 1, 0), pr.threshold(thr, 1, 0)
    assert got_t.dtype == want_t.dtype == np.int8
    np.testing.assert_array_equal(got_t, want_t)
    return got_t


@pytest.mark.parametrize("name,kw", [
    ("stack_1bit.tif", {}),
    ("seq_%04d.tif", {}),
    ("seq_0003.tif", {}),
    ("vol_uint8.raw", {"raw_dims": (N, N, N), "raw_dtype": "UINT8"}),
    ("vol.dat", {}),
    ("vol.hdf5", {}),
])
def test_readers_match_jax_on_sample_files(sample, name, kw):
    if name.endswith(".hdf5") and not _has("h5py"):
        pytest.skip("h5py is not installed")
    d, vol = sample
    jr, pr = _both(d / name, **kw)
    phase = _same_reader(jr, pr)
    if name == "seq_0003.tif":  # an existing file of a sequence: one page
        vol = vol[:, :, 3:4]
    np.testing.assert_array_equal(phase, vol.astype(np.int8))


@pytest.mark.parametrize("dtype", list(RawDataType))
def test_raw_reader_every_datatype_matches_jax(tmp_path, dtype):
    rng = np.random.default_rng(4)
    vals = (rng.random((5, 7, 6)) * 100).astype(np.dtype(dtype.value))
    path = tmp_path / f"v_{dtype.name}.raw"
    vals.tofile(path)
    jr, pr = _both(path, raw_dims=(6, 7, 5), raw_dtype=dtype.name)
    _same_reader(jr, pr, thr=50.0)
    assert pr.get_value(1, 2, 3) == jr.get_value(1, 2, 3)


@pytest.mark.parametrize("case", ["multipage_u16", "tiled_f64", "bits_fo1",
                                  "bits_fo2_tiled", "bigtiff_i32"])
def test_tiff_codec_layouts_match_jax(tmp_path, case):
    rng = np.random.default_rng(5)
    if case.startswith("bits"):
        pages = [rng.random((12, 20)) < 0.5 for _ in range(3)]
    elif case.endswith("f64"):
        pages = [rng.standard_normal((12, 20)) for _ in range(3)]
    else:
        dt = np.uint16 if case.endswith("u16") else np.int32
        pages = [rng.integers(0, 1000, (12, 20)).astype(dt) for _ in range(4)]
    path = tmp_path / f"{case}.tif"
    write_tiff(str(path), pages, tile=(8, 16) if "tiled" in case else None,
               fill_order=2 if "fo2" in case else 1,
               big=True if "bigtiff" in case else None)
    jr, pr = _both(path)
    assert pr._raw is not None  # the numpy codec, not PIL
    assert (pr.bits_per_sample, pr.sample_format) == (
        jr.bits_per_sample, jr.sample_format)
    _same_reader(jr, pr, thr=0.2 if case.endswith("f64") else 0.5)


def _striped_tiff(path, pages, rows_per=None, pad=0, bo="<"):
    """An uncompressed single-sample classic TIFF of ``pages`` ((H, W)
    arrays; bool pages 1 bit, FillOrder 1), written by hand: byte order
    ``bo``, ``rows_per`` rows a strip (None: one strip a page), and after
    each strip ``pad`` bytes that its byte count includes."""
    with open(path, "wb") as f:
        f.write((b"II" if bo == "<" else b"MM") + struct.pack(bo + "HI", 42, 0))
        link = 4
        for p in pages:
            h, w = p.shape
            rows_per_ = h if rows_per is None else rows_per
            if p.dtype == bool:
                rows, bps, fmt = np.packbits(p, axis=1), 1, 1
            else:
                rows = p.astype(p.dtype.newbyteorder(bo)).view(np.uint8)
                bps = 8 * p.dtype.itemsize
                fmt = {"u": 1, "i": 2, "f": 3}[p.dtype.kind]
            offsets, counts = [], []
            for r0 in range(0, h, rows_per_):
                data = rows[r0:r0 + rows_per_].tobytes() + b"\xa5" * pad
                offsets.append(f.tell())
                counts.append(len(data))
                f.write(data)
            entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bps]),
                       (259, 3, [1]), (266, 3, [1]), (273, 4, offsets),
                       (277, 3, [1]), (278, 4, [rows_per_]),
                       (279, 4, counts), (339, 3, [fmt])]
            values = {}
            for tag, typ, vals in entries:
                if len(vals) > 1:  # LONG arrays out of line
                    values[tag] = struct.pack(bo + "I", f.tell())
                    f.write(struct.pack(f"{bo}{len(vals)}I", *vals))
                else:
                    values[tag] = struct.pack(bo + ("H2x" if typ == 3
                                                    else "I"), vals[0])
            ifd = f.tell()
            f.seek(link)
            f.write(struct.pack(bo + "I", ifd))
            f.seek(ifd)
            f.write(struct.pack(bo + "H", len(entries)))
            for tag, typ, vals in entries:
                f.write(struct.pack(bo + "HHI", tag, typ, len(vals))
                        + values[tag])
            link = f.tell()
            f.write(struct.pack(bo + "I", 0))


def _samples(rng, dtype, shape):
    """(H, W) samples of ``dtype``: half drawn over its range, half from
    values at the thresholds and its ends."""
    if dtype == bool:
        return rng.random(shape) < 0.5
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        edge = [np.nan, np.inf, -np.inf, 0.5, 0.1, -0.5, 127.0, 1.0, 0.0]
        drawn = rng.standard_normal(shape) * 100
    else:
        info = np.iinfo(dtype)
        edge = [v for v in (info.min, -1, 0, 1, 2, 127, 128, info.max)
                if info.min <= v <= info.max]
        drawn = rng.integers(info.min, info.max, shape, endpoint=True)
    vals = rng.choice(np.array(edge, dtype), shape)
    return np.where(rng.random(shape) < 0.5, drawn.astype(dtype), vals)


# layouts threshold_tensor takes: (sample dtype, how the file is written)
TAKEN = {
    "bits_fo1": (bool, "write_tiff"),
    "bits_fo2": (bool, "write_tiff_fo2"),
    "bits_strips": (bool, "hand_strips"),
    "bits_strips_padded_be": (bool, "hand_padded_be"),
    "u8": (np.uint8, "write_tiff"),
    "i8": (np.int8, "write_tiff"),
    "u16": (np.uint16, "write_tiff"),
    "i16": (np.int16, "write_tiff"),
    "u32": (np.uint32, "write_tiff"),
    "i32": (np.int32, "write_tiff"),
    "f32": (np.float32, "write_tiff"),
    "u8_be": (np.uint8, "hand_be"),
    "u16_strips_padded": (np.uint16, "hand_padded"),
    "bits_sequence": (bool, "sequence"),
    "u16_sequence": (np.uint16, "sequence"),
    "bits_bigtiff": (bool, "bigtiff"),
    "f32_bigtiff": (np.float32, "bigtiff"),
    "cli_stack": (bool, "write_tiff1"),
}
# layouts it leaves to the host's threshold
HOST = {
    "bits_tiled": (bool, "tiled"),
    "u16_tiled": (np.uint16, "tiled"),
    "u8_compressed": (np.uint8, "compressed"),
    "u16_be": (np.uint16, "hand_be"),
    "i32_be": (np.int32, "hand_be"),
    "f64": (np.float64, "write_tiff"),
    "i64": (np.int64, "write_tiff"),
}


def _stack(tmp_path, dtype, how, pages):
    """Write ``pages`` as ``how`` says; the name to open."""
    path = str(tmp_path / "v.tif")
    if how.startswith("write_tiff") and how != "write_tiff1":
        write_tiff(path, pages, fill_order=2 if how.endswith("fo2") else 1)
    elif how == "write_tiff1":  # the benchmark's writer, volume (X, Y, Z)
        write_tiff1(path, np.stack(pages).transpose(2, 1, 0))
    elif how == "bigtiff":
        write_tiff(path, pages, big=True)
    elif how == "tiled":
        write_tiff(path, pages, tile=(8, 16))
    elif how == "sequence":
        for z, p in enumerate(pages):
            write_tiff(str(tmp_path / f"s_{z:04d}.tif"), [p])
        path = str(tmp_path / "s_%04d.tif")
    elif how == "compressed":
        from PIL import Image

        im = [Image.fromarray(p) for p in pages]
        im[0].save(path, compression="tiff_lzw", save_all=True,
                   append_images=im[1:])
    else:
        _striped_tiff(path, pages,
                      rows_per=3 if "strips" in how or "padded" in how
                      else None,
                      pad=5 if "padded" in how else 0,
                      bo=">" if how.endswith("be") else "<")
    return path


@pytest.mark.parametrize("case", list(TAKEN) + list(HOST))
def test_tiff_threshold_tensor_matches_jax(tmp_path, case):
    """``TiffReader.threshold_tensor`` on the CPU: the int8 volume of the
    JAX package's ``threshold`` and of the port's own, exactly, at every
    threshold and with ``vtrue``, ``vfalse`` swapped; None for a layout it
    leaves to the host."""
    dtype, how = {**TAKEN, **HOST}[case]
    rng = np.random.default_rng(7)
    pages = [_samples(rng, dtype, (7, 13)) for _ in range(5)]  # 13 x 7 x 5
    path = _stack(tmp_path, dtype, how, pages)
    jr, pr = _both(path)
    pages0 = profiling.counters["device_pages"]
    if case in HOST:
        assert pr.threshold_tensor(0.5, 1, 0, "cpu") is None
        assert profiling.counters["device_pages"] == pages0
        return
    assert pr._raw is not None and pr.shape == (13, 7, 5)
    # 0.1 and 2**31 - 1.5 tell a float64 compare from a float32 one
    for thr in (0.5, 0, 1, -0.5, 127, float("nan"), 0.1, 2**31 - 1.5):
        for vtrue, vfalse in ((1, 0), (0, 1)):
            got = pr.threshold_tensor(thr, vtrue, vfalse, "cpu")
            assert got.dtype == torch.int8 and got.is_contiguous()
            want = jr.threshold(thr, vtrue, vfalse)
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(
                got.numpy(), pr.threshold(thr, vtrue, vfalse))
    assert profiling.counters["device_pages"] == pages0 + 16 * 5
    if dtype == bool:
        np.testing.assert_array_equal(
            pr.threshold_tensor(0.5, 1, 0).numpy(),
            np.stack(pages).transpose(2, 1, 0))


INPUTS = """
filename = stack.tif        # a comment
data_path = /data/
results_path = "/tmp/a b/"
phase_id = 0
solver_type = GMRES
calculation_method = flow_through
direction = X Z
hypre.eps = 1e-8
hypre.maxiter = 300
tortuosity.vlo = 0.5
tortuosity.remspot_passes = 2
rev.do_study = true
rev.sizes = 8 16
rev.batch = Off
raw_width = 4
raw.datatype = FLOAT32_BE
voxel_size = 1 1 2
solver.precond = mg
solver.inner_precision = float64
debug.write_active_mask = 1
"""


def test_config_matches_jax():
    jp, pp = j_config.ParmParse(), p_config.ParmParse()
    jp.parse_text(INPUTS)
    pp.parse_text(INPUTS)
    assert pp._store == jp._store
    jc = j_config.DiffusionConfig.from_parmparse(jp)
    pc = p_config.DiffusionConfig.from_parmparse(pp)
    got = dataclasses.asdict(pc)
    assert got.pop("device") == "cuda"
    assert got == dataclasses.asdict(jc)
    pp.parse_text("device = CPU")
    assert p_config.DiffusionConfig.from_parmparse(pp).device == "cpu"
    assert p_config.SOLVER_MAP == j_config.SOLVER_MAP
    for name in list(j_config.SOLVER_MAP) + ["FlexGMRES", "GMRES"]:
        assert p_config.resolve_solver(name) == j_config.resolve_solver(name)
        assert p_config.solver_notice(name) == j_config.solver_notice(name)
    for bad in ("amg", "rev.batch = maybe"):
        with pytest.raises(ValueError):
            if "=" in bad:
                q = p_config.ParmParse()
                q.parse_text("filename = a\n" + bad)
                p_config.DiffusionConfig.from_parmparse(q)
            else:
                p_config.resolve_solver(bad)


@pytest.mark.skipif(not j_native.available(),
                    reason="the native library does not build here")
def test_native_binding_matches_jax():
    assert p_native.available()
    rng = np.random.default_rng(6)
    for dt in p_native.DTYPE_CODES:
        vals = (rng.random((9, 7, 5)) * 100).astype(np.dtype(dt))
        np.testing.assert_array_equal(
            p_native.threshold_decode(vals, 50.0, 1, 0),
            j_native.threshold_decode(vals, 50.0, 1, 0))
    assert p_native.threshold_decode(np.zeros(3, np.complex64), 0, 1, 0) \
        is None
    packed = rng.integers(0, 256, 7).astype(np.uint8)
    for order in (1, 2):
        np.testing.assert_array_equal(
            p_native.unpack_bits(packed, 53, order),
            j_native.unpack_bits(packed, 53, order))
    phase = (rng.random((12, 10, 8)) < 0.5).astype(np.int32)
    got, flips = p_native.remspot(phase)
    want, wflips = j_native.remspot(phase)
    np.testing.assert_array_equal(got, want)
    assert flips == wflips == int((got != phase).sum())


def _inputs(tmp_path, data_dir, filename, **keys):
    res = tmp_path / "results"
    lines = [f"filename = {filename}", f"data_path = {data_dir}/",
             f"results_path = {res}/", "phase_id = 1", "hypre.eps = 1e-9",
             "verbose = 1"]
    lines += [f"{k.replace('__', '.')} = {v}" for k, v in keys.items()]
    path = tmp_path / "run.inputs"
    path.write_text("\n".join(lines) + "\n")
    return path, res


def _jax_results_txt(path, filename, phase, dirs, method):
    pc, tc = volume_fraction_counts(phase, 1)
    vf = pc / tc
    taus = {f"Tortuosity_{'XYZ'[d]}": oi.tortuosity(
        phase, 1, d, eps=1e-9, method=method, mesh=None).value for d in dirs}
    j_writers.write_results_txt(str(path), Path(filename).name, 1, vf, taus)
    return taus


def _same_text(got: str, want: str):
    gl, wl = got.splitlines(), want.splitlines()
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        gk, _, gv = g.partition(": ")
        wk, _, wv = w.partition(": ")
        if g.startswith("#") or not gv:
            assert g == w
            continue
        assert gk == wk
        gf, wf = float(gv), float(wv)
        assert gf == wf or abs(gf - wf) <= 1e-6 * abs(wf), (g, w)


@pytest.mark.parametrize("direction,solver,method", [
    ("X", "FlexGMRES", "cg"),
    ("All", "FlexGMRES", "cg"),
    ("X", "GMRES", "flexgmres"),
    ("Z", "FGMRES", "flexgmres"),
])
def test_cli_flow_through_matches_jax(sample, tmp_path, capsys, direction,
                                      solver, method):
    d, vol = sample
    inputs, res = _inputs(tmp_path, d, "stack_1bit.tif",
                          calculation_method="flow_through",
                          direction=direction, solver_type=solver)
    assert diffusion.main([str(inputs), "device=cpu"]) == 0
    out = capsys.readouterr().out
    phase = j_writers.read_any(str(d / "stack_1bit.tif")).threshold(0.5, 1, 0)
    dirs = diffusion.parse_directions(direction)
    want = tmp_path / "want.txt"
    taus = _jax_results_txt(want, "stack_1bit.tif", phase, dirs, method)
    _same_text((res / "results.txt").read_text(), want.read_text())
    assert "Volume Fraction = " in out and "Total run time" in out
    for name, tau in taus.items():
        assert f">>> Calculated Tortuosity ({name[-1]}): " in out


def test_cli_homogenization_matches_jax(sample, tmp_path, capsys):
    d, vol = sample
    inputs, res = _inputs(tmp_path, d, "vol.dat",
                          calculation_method="homogenization")
    assert diffusion.main([str(inputs), "device=cpu"]) == 0
    out = capsys.readouterr().out
    rows = [line.strip() for line in out.splitlines()
            if line.strip().startswith("[")]
    got = np.array([[float(v) for v in r.strip("[]").split(",")]
                    for r in rows])
    want = oi.effective_diffusivity(vol.astype(np.int8), 1, mesh=None).deff
    # the console prints 8 significant digits
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-7, atol=1e-9)
    assert "Full Domain Effective Diffusivity Tensor" in out


def test_cli_one_cell_thick_volume_gives_inf(tmp_path, capsys):
    phase = (np.random.default_rng(3).random((1, 20, 20)) < 0.8)
    phase.T.astype(np.uint8).tofile(tmp_path / "thin.raw")
    inputs, res = _inputs(tmp_path, tmp_path, "thin.raw",
                          calculation_method="flow_through", direction="X",
                          raw__width=1, raw__height=20, raw__depth=20)
    assert diffusion.main([str(inputs), "device=cpu"]) == 0
    want = tmp_path / "want.txt"
    _jax_results_txt(want, "thin.raw", phase.astype(np.int8), [0], "cg")
    got = (res / "results.txt").read_text()
    assert got == want.read_text()
    assert "Tortuosity_X: inf" in got


def test_cli_module_entry_and_usage(sample, tmp_path):
    d, _ = sample
    inputs, res = _inputs(tmp_path, d, "vol_uint8.raw",
                          calculation_method="flow_through", direction="Z",
                          raw_width=N, raw_height=N, raw_depth=N)
    run = subprocess.run(
        [sys.executable, "-m", "openimpala_tpu_torch.diffusion", str(inputs),
         "device=cpu"], cwd=REPO, capture_output=True, text=True)
    assert run.returncode == 0, run.stderr
    assert (res / "results.txt").read_text().startswith(
        "# Tortuosity Calculation Results (Flow-Through Method)")
    assert diffusion.main([]) == 2


def test_cli_thresholds_the_stack_on_its_device(tmp_path, monkeypatch):
    """The CLI on a 1-bit stack (the benchmark's writer): ``results.txt``
    the same whether the device thresholded it or the host did (the method
    patched to return None), and the request's ``device_pages`` its
    pages, then none."""
    vol = msd.make_blobs(12, 0.4, 4)[:, :10, :9]  # 12 x 10 x 9
    write_tiff1(str(tmp_path / "stack.tif"), vol)
    inputs, res = _inputs(tmp_path, tmp_path, "stack.tif",
                          calculation_method="flow_through", direction="All")
    monkeypatch.setattr(profiling, "_ENABLED", True)
    texts, pages = [], []
    try:
        for host in (False, True):
            if host:
                monkeypatch.setattr(TiffReader, "threshold_tensor",
                                    lambda *args, **kwargs: None)
            assert diffusion.main([str(inputs), "device=cpu"]) == 0
            texts.append((res / "results.txt").read_text())
            record = profiling.requests[-1]
            assert record["entry"] == "cli"
            assert "oi/cli/read_threshold" in record["spans"]
            pages.append(record["counters"]["device_pages"])
    finally:
        profiling.reset()
    assert texts[0] == texts[1]
    assert pages == [9, 0]
    want = tmp_path / "want.txt"
    _jax_results_txt(want, "stack.tif", vol.astype(np.int8), [0, 1, 2], "cg")
    _same_text(texts[0], want.read_text())
