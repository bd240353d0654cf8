#!/usr/bin/env python3
"""Where the time of the port's solves goes on one NVIDIA GPU.

    python3 -m scripts.profile_torch_solve [--n 512] [--precond sa]
        [--precond-opts '{"cycle": "w", "coeff_dtype": "bfloat16"}']
        [--entry tortuosity|deff|rev] [--lanes auto|true|false] [--eager]

(from the repo root)

Runs one entry point of ``openimpala_tpu_torch`` (``tortuosity`` along X,
``effective_diffusivity``, or ``rev_study`` with 64 crops of 64^3) once to
build the kernels and warm
the allocator, then once more under ``torch.profiler`` (CPU + CUDA
activities), and prints: the per-step wall seconds, the device busy time
(sum of kernel and copy durations, one stream) against the wall time of
the call and of its solve step, the device time of the hand-written
kernels (K1 to K5) against PyTorch's own kernels, and the top kernels by
device time; for ``--entry deff``, whether the three cell problems ran as
lockstep lanes (``--lanes`` is ``effective_diffusivity``'s ``lanes``).
The solvers' PCG chunks run as CUDA graphs, as the entry points run them
(``utils/graphs.py``); ``--eager`` profiles the eager twin instead
(``graphs._eager_twin``).  The device's idle milliseconds are the wall
less the busy time.  The last line is one JSON object with those numbers.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from openimpala_tpu_torch import (
    effective_diffusivity, rev_study, tortuosity)
from openimpala_tpu_torch.utils import graphs
from openimpala_tpu_torch.utils.sample_data import make_blobs

HAND = ("k1_stream", "k1_planes", "k1_restrict", "k2_cells", "k3_cells", "k4_planes",
        "k5_stream", "reduce_partials")


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=512,
                    help="edge of the blobs volume (porosity 0.4, seed 0)")
    ap.add_argument("--precond", default="auto",
                    help="preconditioner: auto (Galerkin V-cycle) or sa")
    ap.add_argument("--precond-opts", default="{}",
                    help="JSON options of the preconditioner; a "
                         "coeff_dtype is named as a torch dtype")
    ap.add_argument("--entry", default="tortuosity",
                    choices=("tortuosity", "deff", "rev"),
                    help="entry point: tortuosity (X), deff "
                         "(effective_diffusivity) or rev (rev_study, 64 "
                         "crops of 64^3, the batched solver)")
    ap.add_argument("--lanes", default="auto",
                    choices=("auto", "true", "false"),
                    help="--entry deff: run the three cell problems as "
                         "lockstep lanes (true), one after the other "
                         "(false), or as the memory gate decides (auto)")
    ap.add_argument("--eager", action="store_true",
                    help="run the solvers' chunks eagerly (the twin of the "
                         "graphed run)")
    args = ap.parse_args(argv)
    lanes = {"auto": "auto", "true": True, "false": False}[args.lanes]
    opts = json.loads(args.precond_opts)
    if isinstance(opts.get("coeff_dtype"), str):
        opts["coeff_dtype"] = getattr(torch, opts["coeff_dtype"])
    solve = dict(precond=args.precond, precond_opts=opts, device="cuda")
    if not torch.cuda.is_available():
        print("profile_torch_solve: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    vol = make_blobs(args.n, 0.4, 0)
    lanes_ran = []

    def run(timings=None):
        if args.entry == "tortuosity":
            r = tortuosity(vol, 1, "X", timings=timings, **solve)
            return r.iterations, f"tau={r.value!r}"
        if args.entry == "deff":
            r = effective_diffusivity(vol, 1, timings=timings, lanes=lanes,
                                      **solve)
            lanes_ran[:] = [r.lanes]
            return sum(r.iterations), (f"D_xx={float(r.deff[0, 0])!r} "
                                       f"lanes={r.lanes}")
        out = rev_study(vol, 1, sizes=(64,), num_samples=64, device="cuda")
        return 0, f"converged={sum(s.converged for s in out)}/{len(out)}"

    mode = graphs._eager_twin() if args.eager else contextlib.nullcontext()
    with mode:
        run()  # build kernels, warm up
        graphs.reset_stats()
        timings = {}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            iterations, what = run(timings)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    gstats = dict(graphs.stats)
    print(f"chunks {'eager' if args.eager else 'graphed'}: "
          + json.dumps(gstats))
    print(f"entry={args.entry} precond={args.precond} "
          f"opts={args.precond_opts} {what} iterations={iterations} "
          f"wall_s={wall:.3f} (under the profiler)")
    print("step_s " + json.dumps({k: round(v, 4) for k, v in timings.items()}))

    rows = []
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type is not None and \
                "cuda" in str(evt.device_type).lower():
            rows.append((evt.key, evt.count, us))
    rows.sort(key=lambda r: -r[2])
    busy_ms = sum(r[2] for r in rows) / 1e3
    hand_ms = sum(r[2] for r in rows if r[0].startswith(HAND) or
                  any(h in r[0] for h in HAND)) / 1e3
    solve_s = timings.get("solve", float("nan"))
    print(f"device busy {busy_ms:.1f} ms of {wall * 1e3:.1f} ms wall "
          f"({busy_ms / (wall * 1e3):.1%}; idle {wall * 1e3 - busy_ms:.1f} "
          f"ms); of the solve step {solve_s * 1e3:.1f} ms")
    print(f"hand-written kernels {hand_ms:.1f} ms, PyTorch kernels and "
          f"copies {busy_ms - hand_ms:.1f} ms")
    print("top kernels by device time (ms total, launches, us each):")
    for key, count, us in rows[:20]:
        print(f"  {us / 1e3:9.2f} ms  {count:7d}  {us / count:9.2f} us  "
              f"{key[:100]}")
    print(json.dumps({
        "card": card, "n": args.n, "entry": args.entry,
        "precond": args.precond,
        "precond_opts": args.precond_opts, "iterations": iterations,
        "eager": args.eager, "graphs": gstats,
        "device_idle_ms": wall * 1e3 - busy_ms,
        "lanes": lanes_ran[0] if lanes_ran else None,
        "wall_s": wall, "steps_s": timings, "device_busy_ms": busy_ms,
        "hand_kernels_ms": hand_ms, "torch_kernels_ms": busy_ms - hand_ms,
        "top": [{"name": k[:100], "launches": c, "ms": u / 1e3}
                for k, c, u in rows[:20]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
