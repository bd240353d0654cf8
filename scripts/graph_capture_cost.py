#!/usr/bin/env python3
"""What a CUDA graph costs and saves on one solve of the port, on one
NVIDIA GPU:

    python3 -m scripts.graph_capture_cost [--n 512] [--entry tortuosity]
        [--precond auto] [--reps 2]

(from the repo root).  Runs the entry point (``tortuosity`` along X,
``effective_diffusivity``, or ``rev_study`` with 64 crops of 64^3) once to
build and warm up, then ``--reps`` times graphed and eagerly
(``graphs._eager_twin``) in turns, and prints for each graphed run the
wall and, per graph holder, the host seconds of the eager first step
(enqueue only), that step's device seconds (CUDA events), and the host
seconds of the step's and the tail's captures, body and instantiation
(``capture_end``) apart; for each eager run the wall.  The last line is one JSON object with those numbers and
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from openimpala_tpu_torch import effective_diffusivity, rev_study, tortuosity
from openimpala_tpu_torch.ops import stencil_cuda as sc
from openimpala_tpu_torch.utils import graphs
from openimpala_tpu_torch.utils.sample_data import make_blobs

G = graphs.ChunkGraph
_CALL, _RECORD = G._call, graphs._record
rows = []
_naming = [None]  # the body ``_timed_record`` records


def _timed_call(self, name):
    """A holder's first step: the eager step's host enqueue seconds and
    device time (CUDA events), then its capture (``_timed_record``)."""
    _naming[0] = name
    if name != "step" or "step" in self.graphs:
        return _CALL(self, name)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = self.fns[name](*self.buffers)
    end.record()
    rows.append({"eager_step_host_s": time.perf_counter() - t0,
                 "_events": (start, end)})
    self.graphs[name] = graphs.capture(self.fns[name], *self.buffers)
    graphs.stats["captures"] += 1
    return out


def _timed_record(fn, args):
    """``graphs._record`` with the body and the instantiation timed
    apart."""
    name = _naming[0]
    before = sc.snapshot_counts()
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(args[0].device)
    try:
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = fn(*args)
                t1 = time.perf_counter()
            finally:
                graph.capture_end()
    finally:
        deltas = sc.counts_since(before)
        sc.restore_counts(before)
    rows[-1].update({f"{name}_capture_body_s": t1 - t0,
                     f"{name}_instantiate_s": time.perf_counter() - t1})
    graphs.stats["capture_s"] += time.perf_counter() - t0
    return graph, out, deltas


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--entry", default="tortuosity",
                    choices=("tortuosity", "deff", "rev"))
    ap.add_argument("--precond", default="auto")
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("graph_capture_cost: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    vol = make_blobs(args.n, 0.4, 0)

    def call():
        if args.entry == "tortuosity":
            return tortuosity(vol, 1, "X", precond=args.precond).value
        if args.entry == "deff":
            return float(effective_diffusivity(
                vol, 1, precond=args.precond).deff[0, 0])
        out = rev_study(vol, 1, sizes=(64,), num_samples=64)
        return float(out[0].deff[0, 0])

    call()  # build the kernels, warm the allocator
    out = {"card": card, "n": args.n, "entry": args.entry,
           "precond": args.precond, "graphed": [], "eager_wall_s": []}
    for _ in range(args.reps):
        rows.clear()
        G._call, graphs._record = _timed_call, _timed_record
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            value = call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            G._call, graphs._record = _CALL, _RECORD
        for r in rows:
            start, end = r.pop("_events")
            r["eager_step_device_s"] = start.elapsed_time(end) / 1e3
        print(f"graphed wall {wall:.3f} s value {value!r} captures "
              + json.dumps(rows), flush=True)
        out["graphed"].append({"wall_s": wall, "captures": list(rows)})
        with graphs._eager_twin():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            value = call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        print(f"eager wall {wall:.3f} s value {value!r}", flush=True)
        out["eager_wall_s"].append(wall)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
