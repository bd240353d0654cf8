#!/usr/bin/env python3
"""K1's two routes side by side on one NVIDIA GPU: the stream route under
each (rows per thread, X run) against the general route, mode by mode.

    python3 -m scripts.tune_k1 [--n 512 256] [--runs 32 64 128]
        [--variant=-DK1_STAGES=8] [--out FILE] [--check-only]

(from the repo root)

First holds both routes against the plain forms on ``chip_smoke.py``'s
small volumes at the routes' seams (``K1_SEAMS``), then times every
mode on an n^3 system (a random mask of 70 % free cells; clamped, and all
periodic) from a CUDA graph, for the default build and for each
``--variant`` of the source's compile-time knobs.  Prints one line per
measurement and, with ``--out FILE``, writes all of them there as JSON.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from openimpala_tpu_torch.ops import stencil_cuda as sc
from openimpala_tpu_torch.ops.stencil import (
    make_cell_problem_system, make_tortuosity_system)

MODES = ("matvec_dot", "matvec", "resid", "sweep", "restrict")


def system_of(kind, mask, dx, dtype):
    if kind == "flow":
        return make_tortuosity_system(mask, 0, -1.0, 1.0, dx=dx, dtype=dtype)
    return make_cell_problem_system(mask, 1, dx=dx, dtype=dtype)


def call(mode, x, r, s, **plan):
    dot = mode == "matvec_dot"
    return sc.k1_stencil("matvec" if dot else mode, x, r, s.code, s.w,
                         s.periodic, with_dot=dot, **plan)


def times(n, gen, dev, records, runs, variant):
    rng = np.random.default_rng(1)
    mask = torch.from_numpy(rng.random((n, n, n)) < 0.7).to(dev)
    plans = [{"route": "general"}] + [
        {"route": "stream", "rows": rows, "run": run}
        for rows in (2, 1) for run in runs if run <= n]
    for kind in ("flow", "cell"):
        for dtype in (torch.float32, torch.float64):
            s = system_of(kind, mask, (1, 1, 1), dtype)
            x = torch.where(s.free, torch.randn(
                (n, n, n), generator=gen, dtype=dtype, device=dev), 0.0)
            r = torch.where(s.free, torch.randn(
                (n, n, n), generator=gen, dtype=dtype, device=dev), 0.0)
            for mode in MODES:
                if dtype == torch.float64 and mode != "matvec":
                    continue
                bound = sc.k1_cost(mode, (n, n, n), dtype)[0] / \
                    cs.PEAK_BYTES_S * 1e3
                for plan in plans:
                    if mode == "restrict" and plan.get("rows") == 1:
                        continue
                    ms = cs.graph_ms(lambda: call(mode, x, r, s, **plan))
                    rec = {"variant": variant, "n": n, "kind": kind,
                           "dtype": cs._tag(dtype), "mode": mode, **plan,
                           "ms": ms, "bound_ms": bound,
                           "of_bound": bound / ms}
                    records.append(rec)
                    print("time " + json.dumps(rec), flush=True)
            del s, x, r
            torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs="*", default=[512, 256])
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--out", help="write the measurements here as JSON")
    ap.add_argument("--runs", type=int, nargs="*",
                    default=[32, 64, 128, 172, 256, 512],
                    help="X runs of the stream route to time")
    ap.add_argument("--variant", action="append", default=[],
                    help="extra nvcc flags of a variant build to time after "
                         "the default one, e.g. '-DK1_STAGES=8' (repeatable;"
                         " the default build is timed again at the end)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tune_k1: no CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    _, out = sc.build(("k1",))["k1"]
    for line in out.splitlines():
        if "registers" in line or "spill" in line or "warning" in line:
            print("ptxas " + line.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    chk = cs.Checker()
    cs.phase_kernels_k1_seams(chk, gen, dev, np.random.default_rng(0))
    print("seams " + json.dumps(chk.max_err, sort_keys=True), flush=True)
    records = []
    if not args.check_only:
        flags = sc.NVCC_FLAGS
        variants = [""] + args.variant + ([""] if args.variant else [])
        for variant in variants:
            # another set of flags is another library name
            sc.NVCC_FLAGS = flags + tuple(variant.split())
            sc._libs.pop("k1", None)
            _, out = sc.build(("k1",))["k1"]
            regs = [ln.split("Used ")[1].split(",")[0]
                    for ln in out.splitlines() if "Used " in ln]
            spills = sorted({ln.strip() for ln in out.splitlines()
                             if "spill" in ln and "0 bytes spill stores, 0"
                             not in ln})
            print(f"variant {variant!r}: {' '.join(regs)} {spills}",
                  flush=True)
            for n in args.n:
                times(n, gen, dev, records, args.runs, variant)
        sc.NVCC_FLAGS = flags
        sc._libs.pop("k1", None)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(records))
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
