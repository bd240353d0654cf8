#!/usr/bin/env python3
"""The port's X-slab decomposition against one card, on one machine.

    python3 -m scripts.torch_sharded [--n 512] [--ranks 4]
        [--configs nccl gloo gloo1] [--out sharded.json]

(from the repo root).  On ``make_blobs(n, 0.4, 0)``, phase 1, X, eps 1e-9:
first ``tortuosity`` on one card (``cuda:0``), then the same solve on
``--ranks`` ranks (``parallel.spawn``), each reading its X slab from a
uint8 RAW file of the volume (``io.threshold_sharded``), once per config:

* ``nccl``: one rank per card, ``nccl`` (needs as many cards as ranks);
* ``gloo``: one rank per card, ``gloo`` (collectives through host
  buffers);
* ``gloo1``: every rank on ``cuda:0``, ``gloo`` (what ``chip_smoke.py``'s
  ``sharded`` phase runs on a one-card machine).

For each: tau and its difference to the one-card value, iterations, the
wall of the call (ingest, percolation, solve, fluxes) and its steps, the
peak memory, and the halo exchanges, gathers and sums with their bytes,
per rank.  Prints the card's name and power limit first and one JSON
object last.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from openimpala_tpu_torch import tortuosity
from openimpala_tpu_torch.parallel import spawn
from openimpala_tpu_torch.utils.sample_data import make_blobs

CONFIGS = {"nccl": ("nccl", "cuda"), "gloo": ("gloo", "cuda"),
           "gloo1": ("gloo", "cuda:0")}


def _rank(mesh, raw, n):
    """One rank: its slab from ``raw`` into ``tortuosity`` under the mesh,
    timed with the counters of ``parallel.mesh.stats`` zeroed before."""
    from openimpala_tpu_torch.io import RawReader, threshold_sharded
    from openimpala_tpu_torch.parallel import mesh as pm

    dev = mesh.device
    torch.cuda.reset_peak_memory_stats(dev)
    pm.reset_stats()
    timings = {}
    mesh.barrier()
    t0 = time.perf_counter()
    slab, shape = threshold_sharded(RawReader(raw, n, n, n, "UINT8"), 0.5,
                                    mesh)
    res = tortuosity(slab, 1, "X", eps=1e-9, mesh=mesh, device=dev,
                     original_shape=shape, timings=timings)
    torch.cuda.synchronize(dev)
    return {"rank": mesh.rank, "device": str(dev), "tau": res.value,
            "iterations": res.iterations, "active_vf": res.active_vf,
            "converged": res.converged,
            "flux_conserved": res.flux_conserved,
            "percolation": res.percolation_method,
            "wall_s": time.perf_counter() - t0, "step_s": timings,
            "comm": dict(pm.stats),
            "peak_mem_GB": torch.cuda.max_memory_allocated(dev) / 1e9}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--configs", nargs="+", default=list(CONFIGS),
                    choices=list(CONFIGS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_sharded: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout,
        flush=True)
    vol = make_blobs(args.n, 0.4, 0)
    tortuosity(make_blobs(64, 0.4, 0), 1, "X", device="cuda:0")  # build
    t0 = time.perf_counter()
    ref = tortuosity(vol, 1, "X", eps=1e-9, device="cuda:0")
    torch.cuda.synchronize()
    one = {"tau": ref.value, "iterations": ref.iterations,
           "active_vf": ref.active_vf,
           "wall_s": time.perf_counter() - t0}
    print(f"one card: {json.dumps(one)}", flush=True)
    out = {"n": args.n, "ranks": args.ranks, "cards":
           torch.cuda.device_count(), "one_card": one, "configs": {}}
    tmp = Path(tempfile.mkdtemp(prefix="torch_sharded_"))
    try:
        raw = tmp / "vol.raw"
        np.ascontiguousarray(vol.T).tofile(raw)
        for name in args.configs:
            backend, device = CONFIGS[name]
            if device == "cuda" and torch.cuda.device_count() < args.ranks:
                print(f"{name}: skipped, {torch.cuda.device_count()} "
                      f"card(s) for {args.ranks} ranks", flush=True)
                continue
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            ranks = spawn.run("scripts.torch_sharded:_rank", args.ranks,
                              args=(str(raw), args.n), backend=backend,
                              device=device, timeout=600, threads=2,
                              workdir=tmp / name)
            world_s = time.perf_counter() - t0
            r0 = ranks[0]
            for r in ranks:
                if r["tau"] != r0["tau"] or not (
                        r["converged"] and r["flux_conserved"]):
                    raise SystemExit(f"{name}: rank {r['rank']} {r}")
            rel = abs(r0["tau"] - one["tau"]) / abs(one["tau"])
            if rel > 1e-6 or abs(r0["iterations"] - one["iterations"]) > 2:
                raise SystemExit(f"{name}: tau {r0['tau']!r} ({rel:.3e}), "
                                 f"{r0['iterations']} iterations against "
                                 f"{one}")
            out["configs"][name] = {"backend": backend, "device": device,
                                    "tau_rel": rel, "world_s": world_s,
                                    "ranks": ranks}
            print(f"{name}: tau={r0['tau']!r} (rel {rel:.3e}) iterations="
                  f"{r0['iterations']} wall_s "
                  + ", ".join(f"{r['wall_s']:.3f}" for r in ranks)
                  + f" (one card {one['wall_s']:.3f}); world {world_s:.1f} "
                  f"s; rank 1 " + json.dumps(ranks[1]["step_s"])
                  + " " + json.dumps(ranks[1]["comm"]), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
