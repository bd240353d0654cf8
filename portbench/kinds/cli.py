"""One run of the port's CLI on a TIFF stack: ``diffusion.main([inputs])``,
as ``python -m openimpala_tpu_torch.diffusion inputs`` runs it, in this
process.  A request reads and thresholds the stack, counts the volume
fraction, solves tau along X, Y and Z and writes ``results.txt``.

``prepare`` writes each volume once, before the warm-up, as an
uncompressed 1-bit multi-page TIFF, as upstream's sample stack is, by the
benchmark's own writer (not the package's, so that the reader under test
decodes bytes the package did not write) and, beside it, the inputs file
the configuration fixes.  The answer is ``results.txt`` as the CLI wrote
it (9 decimals).  Compared, on ``check["answers"]`` volumes: the phase's
cells that the volume fraction gives (exact) and tau along each direction
against the plain reference (``tortuosity.reference``, relative gaps).
"""

from __future__ import annotations

import contextlib
import importlib
import math
import os
import struct
import sys
import types

import numpy as np

from . import Lazy, stratified
from . import tortuosity as flow

DIRECTIONS = ("X", "Y", "Z")
STACK, INPUTS, RESULTS = "stack.tif", "inputs", "results"


def _ifd(nx: int, ny: int, offset: int, nxt: int) -> bytes:
    """One page's directory: 1 bit a sample, black is zero, rows packed
    most significant bit first and padded to a byte, a single strip of
    ``ny`` rows at ``offset``, the next directory at ``nxt`` (0: the
    last)."""
    row = (nx + 7) // 8
    entries = [  # (tag, type, value): type 3 SHORT, 4 LONG
        (256, 4, nx), (257, 4, ny), (258, 3, 1), (259, 3, 1), (262, 3, 1),
        (266, 3, 1), (273, 4, offset), (277, 3, 1), (278, 4, ny),
        (279, 4, row * ny)]
    out = struct.pack("<H", len(entries))
    for tag, typ, value in entries:
        out += struct.pack("<HHIH2x" if typ == 3 else "<HHII", tag, typ, 1,
                           value)
    return out + struct.pack("<I", nxt)


IFD_BYTES = len(_ifd(0, 0, 0, 0))


def write_tiff1(path: str, volume: np.ndarray):
    """``volume`` (X, Y, Z) of 0 and 1 as an uncompressed little-endian
    1-bit TIFF of Z pages, one strip each: page z holds
    ``volume[:, :, z].T`` (rows Y, columns X), the pages' data first,
    their directories after it."""
    volume = np.asarray(volume, np.uint8)
    if volume.max() > 1:
        raise ValueError("a 1-bit stack holds 0 and 1 only")
    nx, ny, nz = volume.shape
    row = (nx + 7) // 8
    # byte b of a row holds x = 8b .. 8b + 7, the first in the highest bit;
    # packed along X as the volume lies, then turned to (Z, Y, row)
    bits = np.zeros((row, ny, nz), np.uint8)
    for k in range(8):
        plane = volume[k::8]
        bits[:len(plane)] |= plane << (7 - k)
    bits = np.ascontiguousarray(bits.transpose(2, 1, 0))
    page = ny * row
    data_end = 8 + bits.nbytes
    first = data_end + (data_end & 1)  # directories on a word boundary
    if first + nz * IFD_BYTES >= 2 ** 32:
        raise ValueError("a classic TIFF holds under 4 GiB")
    with open(path, "wb") as f:
        f.write(b"II" + struct.pack("<HI", 42, first))
        f.write(bits)
        f.write(b"\0" * (first - data_end))
        f.write(b"".join(
            _ifd(nx, ny, 8 + z * page,
                 first + (z + 1) * IFD_BYTES if z + 1 < nz else 0)
            for z in range(nz)))


def _inputs_text(config, folder) -> str:
    keys = {"filename": STACK, "data_path": folder + os.sep,
            "results_path": os.path.join(folder, RESULTS) + os.sep,
            "phase_id": config["phase_id"], **config["inputs"]}
    return "".join(f"{k} = {v}\n" for k, v in keys.items())


def prepare(volumes, config, traffic, workdir):
    """Each volume's folder: its stack and inputs file; returns the inputs
    files' paths, one a volume."""
    feed = []
    for v, volume in enumerate(volumes):
        folder = os.path.join(workdir, f"volume{v}")
        os.makedirs(folder)
        write_tiff1(os.path.join(folder, STACK), volume)
        feed.append(os.path.join(folder, INPUTS))
        with open(feed[-1], "w") as f:
            f.write(_inputs_text(config, folder))
    return feed


def read_results(path):
    """``results.txt``: the volume fraction and tau by direction (None
    where the file lacks one)."""
    got = {}
    with open(path) as f:
        for line in f:
            key, sep, value = line.partition(":")
            if sep and not key.startswith("#"):
                got[key.strip()] = float(value)
    return types.SimpleNamespace(
        volume_fraction=got.get("VolumeFraction"),
        tau={d: got.get(f"Tortuosity_{d}") for d in DIRECTIONS})


def call(port, inputs, request, config, device, timings=None):
    """The CLI on the volume's inputs file (``device`` other than CUDA as
    the CLI's own override); its console output goes to standard error,
    so that the result line stays the last line of standard output."""
    results = os.path.join(os.path.dirname(inputs), RESULTS, "results.txt")
    if os.path.exists(results):  # an answer is this request's file
        os.remove(results)
    argv = [inputs] if str(device) == "cuda" else [inputs, f"device={device}"]
    with contextlib.redirect_stdout(sys.stderr):
        rc = importlib.import_module(f"{port.__name__}.diffusion").main(argv)
    if rc != 0:
        raise RuntimeError(f"the CLI returned {rc} on {inputs}")
    return read_results(results)


def results(answer) -> int:
    return len(DIRECTIONS)


def expected(request, traffic) -> int:
    return len(DIRECTIONS)


def failed(request, answer, traffic) -> int:
    return sum(not (t is not None and math.isfinite(t))
               for t in answer.tau.values())


def _flow_config(config):
    """The reference's arguments (``tortuosity.reference``) from the
    inputs file."""
    inputs = config["inputs"]
    return {"phase_id": config["phase_id"],
            "vlo": float(inputs["tortuosity.vlo"]),
            "vhi": float(inputs["tortuosity.vhi"]),
            "dx": [float(inputs["voxel_size"])] * 3}


def _gap(a, b):
    return abs(a - b) / abs(b) if a is not None and math.isfinite(a) \
        else math.inf


def compare(answered, volumes, config, traffic, rng, device, dtype):
    vols = sorted({r.volume for r, _ in answered})
    take = stratified(vols, lambda v: 0, traffic.check["answers"], rng)
    worst = {"phase_cells": 0.0, "tau": 0.0}
    for v in take:
        cells = int((volumes[v] == config["phase_id"]).sum())
        taus = {}
        for d in DIRECTIONS:
            ref = flow.reference(volumes[v], d, _flow_config(config), device,
                                 dtype)
            if not (ref["converged"] and math.isfinite(ref["tau"])):
                raise RuntimeError(f"the reference failed on volume {v} "
                                   f"{d}: {ref}")
            taus[d] = ref["tau"]
        for r, a in answered:
            if r.volume != v:
                continue
            vf = a.volume_fraction
            got = {"phase_cells": (abs(round(vf * volumes[v].size) - cells)
                                   if vf is not None and math.isfinite(vf)
                                   else math.inf),
                   "tau": max(_gap(a.tau[d], taus[d]) for d in DIRECTIONS)}
            for k, x in got.items():
                worst[k] = max(worst[k], float(x))
    return worst


def control_answer(volume, request, config, device, dtype):
    """The reference in ``dtype`` in the program's place, printed as
    ``results.txt`` prints it; where its flux gate withholds tau, the tau
    its fluxes give (``tortuosity._tau_of``), so that it reads a number."""
    def make():
        vf = float((volume == config["phase_id"]).sum()) / volume.size
        flow_config = _flow_config(config)
        tau = {}
        for d in DIRECTIONS:
            ref = flow.reference(volume, d, flow_config, device, dtype)
            tau[d] = flow._tau_of(types.SimpleNamespace(
                value=ref["tau"], flux_in=ref["flux_in"],
                flux_out=ref["flux_out"], active_vf=ref["active_vf"]),
                volume.shape, flow.AXES[d], flow_config)
        return types.SimpleNamespace(
            volume_fraction=float(f"{vf:.9f}"),
            tau={d: float(f"{t:.9f}") for d, t in tau.items()})
    return Lazy(make)
