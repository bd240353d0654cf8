#!/usr/bin/env python3
"""The two routing crossovers of the port on one GPU: the lockstep lanes
against the sequential loop of ``effective_diffusivity``, and the batched
REV solver against the sequential one of ``rev_study``.

    python3 -m scripts.torch_crossovers [--lanes-sizes 64 128 256 384 512]
        [--rev-sizes 64 96 128 192 256] [--rev-volume 512] [--pairs 3]
        [--out crossovers.json]

(from the repo root).  Every volume is ``make_blobs(n, 0.4, 0)``, phase 1,
eps 1e-9, every solve graphed (the default on the card).

1. ``effective_diffusivity`` at each ``--lanes-sizes`` edge with
   ``lanes=True`` and ``lanes=False``: one untimed call of each first, then
   ``--pairs`` pairs in alternating order.  Wall seconds (host clock to a
   synchronised result), the peak of ``torch.cuda.max_memory_allocated``
   above what was held before the call, iterations, and the largest
   difference of the two tensors.  The lanes pay at a size where the
   median wall of the sequential loop exceeds the lanes' by more than the
   spread (the larger of the two sides' interquartile ranges).  The data
   behind ``solve/lanes.py::lanes_pay``.
2. ``rev_study`` at each ``--rev-sizes`` crop edge on crops of a
   ``--rev-volume`` volume (512^3): ``batch=True`` (``solve/batched.py``),
   ``batch=False`` with ``lanes=False`` and with ``lanes=True``, in turns.
   The crop count is 64 up to 96^3 (``chip_smoke.py``'s ``main[rev]``)
   and fewer above, never more than ``solve/batched.py::_auto_group_size``
   admits, so each call is one batched group.  Wall seconds and per crop,
   peak memory, converged crops; the batched solver is faster than a
   sequential one where its median wall is lower by more than the spread,
   as above.  The data behind
   ``props/rev.py::auto_batch_max_cells``.

Prints the card's name and power limit first and one JSON object last.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from openimpala_tpu_torch import effective_diffusivity, rev_study
from openimpala_tpu_torch.solve.batched import _auto_group_size
from openimpala_tpu_torch.utils.sample_data import make_blobs

# crops per REV size: main[rev]'s 64 up to 96^3, then fewer, so that the
# sequential side stays within a few seconds a call
REV_CROPS = {64: 64, 96: 64, 112: 48, 128: 32, 160: 24, 192: 16, 256: 8}


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _run(fn):
    """``fn()``'s result, wall seconds and peak bytes above the memory held
    before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, torch.cuda.max_memory_allocated() - base


def _summary(walls: dict) -> dict:
    """Median, range and interquartile range of each side's walls."""
    out = {}
    for k, v in walls.items():
        q1, _, q3 = statistics.quantiles(v, n=4, method="inclusive")
        out[k] = {"median_s": statistics.median(v), "min_s": min(v),
                  "max_s": max(v), "range_s": max(v) - min(v),
                  "iqr_s": q3 - q1}
    return out


def _wins(s: dict, fast: str, slow: str) -> tuple:
    """How much faster ``fast``'s median wall is than ``slow``'s, the
    spread (the larger of the two sides' interquartile ranges), and
    whether the gain exceeds it."""
    gain = s[slow]["median_s"] - s[fast]["median_s"]
    spread = max(s[fast]["iqr_s"], s[slow]["iqr_s"])
    return gain, spread, gain > spread


def _turns(names, pairs: int):
    """``pairs`` rounds of ``names``, every other round reversed."""
    return [list(names) if i % 2 == 0 else list(reversed(names))
            for i in range(pairs)]


def lanes(sizes, pairs: int):
    rows = []
    for n in sizes:
        vol = make_blobs(n, 0.4, 0)
        calls = {
            "lanes": lambda: effective_diffusivity(
                vol, 1, eps=1e-9, lanes=True, device="cuda"),
            "sequential": lambda: effective_diffusivity(
                vol, 1, eps=1e-9, lanes=False, device="cuda")}
        for fn in calls.values():  # graphs, allocator: outside the timing
            fn()
        walls = {k: [] for k in calls}
        peaks, res = {}, {}
        for order in _turns(calls, pairs):
            for name in order:
                r, wall, peak = _run(calls[name])
                walls[name].append(wall)
                peaks[name] = max(peaks.get(name, 0), peak)
                res[name] = r
        s = _summary(walls)
        gain, spread, pay = _wins(s, "lanes", "sequential")
        row = {"n": n, "cells": n ** 3, "walls_s": walls, "summary": s,
               "lanes_gain_s": gain, "spread_s": spread, "lanes_pay": pay,
               "peak_GB": {k: v / 1e9 for k, v in peaks.items()},
               "iterations": {k: list(r.iterations) for k, r in res.items()},
               "converged": {k: r.converged for k, r in res.items()},
               "max_abs_diff": float(np.abs(res["lanes"].deff
                                            - res["sequential"].deff).max())}
        rows.append(row)
        print(f"lanes n={n}: median lanes {s['lanes']['median_s']:.4f} s, "
              f"sequential {s['sequential']['median_s']:.4f} s, gain "
              f"{gain:.4f} s, spread {spread:.4f} s -> pay {pay}; "
              f"peak {row['peak_GB']['lanes']:.2f} / "
              f"{row['peak_GB']['sequential']:.2f} GB; iterations "
              f"{row['iterations']}; diff {row['max_abs_diff']:.2e}",
              flush=True)
    return rows


def rev(vol, sizes, pairs: int):
    rows = []
    for size in sizes:
        # the cached blocks of the calls before count as free to a group
        torch.cuda.empty_cache()
        group = _auto_group_size((size,) * 3, device="cuda")
        crops = min(REV_CROPS.get(size, 8), group)

        def call(**kw):
            return lambda: rev_study(vol, 1, sizes=(size,),
                                     num_samples=crops, eps=1e-9,
                                     device="cuda", **kw)

        calls = {"batched": call(batch=True),
                 "sequential": call(batch=False, lanes=False),
                 "sequential_lanes": call(batch=False, lanes=True)}
        walls = {k: [] for k in calls}
        peaks, conv = {}, {}
        for order in _turns(calls, pairs):
            for name in order:
                samples, wall, peak = _run(calls[name])
                walls[name].append(wall)
                peaks[name] = max(peaks.get(name, 0), peak)
                conv[name] = sum(s.converged for s in samples)
        s = _summary(walls)
        faster = {seq: _wins(s, "batched", seq)[2]
                  for seq in ("sequential", "sequential_lanes")}
        row = {"size": size, "cells": size ** 3, "crops": crops,
               "group_admits": group, "walls_s": walls, "summary": s,
               "per_crop_s": {k: v["median_s"] / crops
                              for k, v in s.items()},
               "batched_faster_than": faster,
               "peak_GB": {k: v / 1e9 for k, v in peaks.items()},
               "converged": conv}
        rows.append(row)
        print(f"rev {crops} x {size}^3: median batched "
              f"{s['batched']['median_s']:.4f} s, sequential "
              f"{s['sequential']['median_s']:.4f} s, sequential lanes "
              f"{s['sequential_lanes']['median_s']:.4f} s; batched faster "
              f"{faster}; converged {conv}", flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes-sizes", type=int, nargs="*",
                    default=[64, 128, 256, 384, 512])
    ap.add_argument("--rev-sizes", type=int, nargs="*",
                    default=[64, 96, 128, 192, 256])
    ap.add_argument("--rev-volume", type=int, default=512,
                    help="edge of the volume the REV crops are drawn from")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--out", default=None,
                    help="also write the JSON object to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_crossovers: no CUDA device", file=sys.stderr)
        return 2
    card = _card()
    print(card, flush=True)
    t0 = time.perf_counter()
    # the kernels' build and load, outside the timing
    warm = make_blobs(32, 0.4, 0)
    for batch in (True, False):
        rev_study(warm, 1, sizes=(16,), num_samples=2, device="cuda",
                  batch=batch)
    out = {"card": card, "pairs": args.pairs,
           "lanes": lanes(args.lanes_sizes, args.pairs)}
    out["rev_volume"] = args.rev_volume
    out["rev"] = rev(make_blobs(args.rev_volume, 0.4, 0), args.rev_sizes,
                     args.pairs)
    out["seconds"] = time.perf_counter() - t0
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
