#!/usr/bin/env python3
"""Percolation methods and lockstep-lane memory of the port on one GPU.

    python3 -m scripts.torch_perc_lanes [--sizes 64 128 256 512]
        [--lanes-sizes 256 512] [--out perc_lanes.json]

(from the repo root).  Two measurements, each on ``make_blobs(n, 0.4, 0)``,
phase 1:

1. ``percolation_mask`` with ``method="host"``, ``"native"`` and
   ``"device"`` at each size in X, Y and Z: the wall milliseconds of each
   call from the numpy volume in memory to the mask (the device method's
   time includes the upload of the volume and a synchronisation; the
   native library is built beforehand), the device fill's rounds, and
   every mask and ``active_vf`` held against the host's bit for bit.  The
   data behind ``ops/floodfill.py::auto_method``.
2. ``effective_diffusivity`` at each ``--lanes-sizes`` size with
   ``lanes=True`` and ``lanes=False``: wall seconds, iterations, the peak
   of ``torch.cuda.max_memory_allocated`` above the memory held before the
   call, in GB and in bytes per cell, and the largest difference of the two
   tensors.  The data behind ``solve/lanes.py::use_lanes``.

Prints the card's name and power limit first and one JSON object last.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from openimpala_tpu_torch import effective_diffusivity
from openimpala_tpu_torch.io import native
from openimpala_tpu_torch.ops import floodfill, packfill
from openimpala_tpu_torch.utils.sample_data import make_blobs


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def percolation(sizes):
    rows = []
    rounds = []
    fill = packfill.percolation_oneshot_packed

    def recording(phase_ok, direction):
        out = fill(phase_ok, direction)
        rounds.append(out[2])
        return out

    packfill.percolation_oneshot_packed = recording
    try:
        for n in sizes:
            vol = make_blobs(n, 0.4, 0)
            for d in (0, 1, 2):
                row = {"n": n, "direction": "XYZ"[d]}
                (host, host_vf), row["host_ms"] = _timed(
                    lambda: floodfill.percolation_mask(vol, 1, d, "host"))
                (nat, nat_vf), row["native_ms"] = _timed(
                    lambda: floodfill.percolation_mask(vol, 1, d, "native"))
                (dev, dev_vf), row["device_ms"] = _timed(
                    lambda: floodfill.percolation_mask(vol, 1, d, "device",
                                                       device="cuda"))
                row["device_rounds"] = rounds[-1]
                row["active_vf"] = host_vf
                row["equal"] = bool(
                    np.array_equal(nat, host) and nat_vf == host_vf
                    and np.array_equal(dev.cpu().numpy(), host)
                    and dev_vf == host_vf)
                row["auto"] = floodfill.auto_method(vol.shape, "cuda")
                rows.append(row)
                print(json.dumps(row), flush=True)
                if not row["equal"]:
                    raise SystemExit(f"masks differ: {row}")
                del host, nat, dev
            torch.cuda.empty_cache()
    finally:
        packfill.percolation_oneshot_packed = fill
    return rows


def lanes(sizes):
    rows = []
    for n in sizes:
        vol = make_blobs(n, 0.4, 0)
        res = {}
        for lanes_on in (True, False):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            r, ms = _timed(lambda: effective_diffusivity(
                vol, 1, eps=1e-9, lanes=lanes_on, device="cuda"))
            peak = torch.cuda.max_memory_allocated() - base
            res[lanes_on] = r
            row = {"n": n, "lanes": lanes_on, "wall_s": ms / 1e3,
                   "iterations": list(r.iterations),
                   "converged": r.converged, "peak_GB": peak / 1e9,
                   "bytes_per_cell": peak / n ** 3,
                   "deff_xx": float(r.deff[0, 0])}
            rows.append(row)
            print(json.dumps(row), flush=True)
        rows[-1]["max_abs_diff_to_lanes"] = float(
            np.abs(res[True].deff - res[False].deff).max())
        print(f"n={n}: lanes against sequential, max abs diff "
              f"{rows[-1]['max_abs_diff_to_lanes']:.3e}", flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="*",
                    default=[64, 128, 256, 512])
    ap.add_argument("--lanes-sizes", type=int, nargs="*", default=[256, 512])
    ap.add_argument("--out", default=None,
                    help="also write the JSON object to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_perc_lanes: no CUDA device", file=sys.stderr)
        return 2
    card = _card()
    print(card, flush=True)
    native.require_lib()  # built before any timing
    # the card's context and the fill's first launches, outside the timing
    floodfill.percolation_mask(make_blobs(32, 0.4, 0), 1, 0, "device",
                               device="cuda")
    out = {"card": card, "percolation": percolation(args.sizes),
           "lanes": lanes(args.lanes_sizes)}
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
