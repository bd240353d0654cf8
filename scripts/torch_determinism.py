#!/usr/bin/env python3
"""Run-to-run determinism of the port's solves and kernels on the card.

    python3 -m scripts.torch_determinism [--n 512] [--solves 4] [--reps 200]
        [--mix] [--skip-kernels]

(from the repo root).  On ``make_blobs(n, 0.4, 0)``, phase 1:

1. ``effective_diffusivity`` (lockstep lanes, eps 1e-9) ``--solves`` times
   with its PCG steps as CUDA graphs and as many times eagerly, alternating:
   each run's per-lane rel_res and a CRC-32 of the tensor's bits; with
   ``--mix``, a graphed ``tortuosity`` (X, eps 1e-9) before each, whose
   τ, iterations and rel_res are printed too;
2. each K1 mode (float32) on the periodic cell problem of every direction,
   and both K2 modes on each Galerkin level of that system, launched
   ``--reps`` times on the same inputs: how many outputs differ in any bit
   from the first;
3. the same K1 matvec with its fused dot replayed ``--reps`` times from a
   CUDA graph, against the eager output.

Prints the card's name and power limit first and one JSON object last.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import zlib

import numpy as np
import torch

from openimpala_tpu_torch import effective_diffusivity, tortuosity
from openimpala_tpu_torch.ops import stencil as st
from openimpala_tpu_torch.ops import stencil_cuda as sc
from openimpala_tpu_torch.solve.preconditioners import (
    GalerkinMGPreconditioner,
)
from openimpala_tpu_torch.utils import graphs
from openimpala_tpu_torch.utils.sample_data import make_blobs


def _crc(a) -> int:
    return zlib.crc32(np.ascontiguousarray(a))


def _solves(vol, n: int, mix: bool) -> list:
    out = []
    for i in range(2 * n):
        eager = i % 2 == 1
        if mix:
            t = tortuosity(vol, 1, "X", eps=1e-9, device="cuda")
            out.append({"tau": t.value, "iterations": t.iterations,
                        "rel_res": t.rel_res})
            print(json.dumps(out[-1]), flush=True)
        if eager:
            with graphs._eager_twin():
                res = effective_diffusivity(vol, 1, eps=1e-9, device="cuda")
        else:
            res = effective_diffusivity(vol, 1, eps=1e-9, device="cuda")
        out.append({"graphed": not eager, "rel_res": list(res.rel_res),
                    "iterations": list(res.iterations),
                    "deff_crc": _crc(res.deff)})
        print(json.dumps(out[-1]), flush=True)
    return out


def _repeat(fn, reps: int) -> int:
    """How many of ``reps`` further calls differ from the first."""
    first = fn()
    first = first if isinstance(first, tuple) else (first,)
    first = tuple(t.clone() for t in first)
    bad = 0
    for _ in range(reps):
        got = fn()
        got = got if isinstance(got, tuple) else (got,)
        bad += not all(torch.equal(a, b) for a, b in zip(got, first))
    return bad


def _kernels(vol, reps: int) -> dict:
    active = torch.from_numpy(vol == 1).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for k in range(3):
        system = st.make_cell_problem_system(active, k, dtype=torch.float32)
        code, w, per = system.code, system.w, system.periodic
        x = torch.randn(tuple(code.shape), generator=gen, device="cuda")
        r = torch.randn(tuple(code.shape), generator=gen, device="cuda")
        modes = {
            "k1_matvec_dot": lambda: sc.k1_stencil(
                "matvec", x, None, code, w, per, with_dot=True),
            "k1_sweep": lambda: sc.k1_stencil("sweep", x, r, code, w, per,
                                              omega=0.9),
            "k1_resid": lambda: sc.k1_stencil("resid", x, r, code, w, per),
            "k1_restrict": lambda: sc.k1_stencil("restrict", x, r, code, w,
                                                 per),
        }
        for name, fn in modes.items():
            out[f"{name} dir {k}"] = _repeat(fn, reps)
        M = GalerkinMGPreconditioner.from_system(system)
        for li, lvl in enumerate(M.levels, start=1):
            xl = torch.randn(tuple(lvl.diag.shape), generator=gen,
                             device="cuda")
            rl = torch.randn(tuple(lvl.diag.shape), generator=gen,
                             device="cuda")
            out[f"k2_matvec dir {k} level {li}"] = _repeat(
                lambda: lvl.apply(xl), reps)
            out[f"k2_sweep dir {k} level {li}"] = _repeat(
                lambda: lvl.sweep(xl, rl, 0.9), reps)
        # the fused matvec from a graph, against its eager output
        want = sc.k1_stencil("matvec", x, None, code, w, per, with_dot=True)
        g = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            g.capture_begin()
            got = sc.k1_stencil("matvec", x, None, code, w, per,
                                with_dot=True)
            g.capture_end()
        torch.cuda.current_stream().wait_stream(side)
        bad = 0
        for _ in range(reps):
            g.replay()
            bad += not (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1]))
        out[f"k1_matvec_dot graphed dir {k}"] = bad
        torch.cuda.synchronize()
        del g, got, want, M, system, x, r
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--solves", type=int, default=4)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--mix", action="store_true")
    ap.add_argument("--skip-kernels", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_determinism: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout,
        flush=True)
    vol = make_blobs(args.n, 0.4, 0)
    result = {"n": args.n}
    if not args.skip_kernels:
        result["kernels"] = _kernels(vol, args.reps)
        print(json.dumps(result["kernels"]), flush=True)
    result["solves"] = _solves(vol, args.solves, args.mix)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
