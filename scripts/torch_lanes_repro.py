#!/usr/bin/env python3
"""Hunt for a run-to-run difference between a graphed D_eff lanes solve
and its eager twin on the card.

    python3 -m scripts.torch_lanes_repro [--n 512] [--rounds 30]
        [--minutes 20] [--max-rounds 400] [--skip-kernels]
        [--out results/lanes_repro.json]
    python3 -m scripts.torch_lanes_repro --stress [--n 512] [--rounds 500]

(from the repo root; it imports ``chip_smoke``).  In one process it does
what ``chip_smoke.py`` does before ``main[deff]``, in its order and at its
sizes: the kernels' build in the warm-up thread, the ``kernels`` phase
(``--skip-kernels`` leaves it out), then the main paths ``iso``, ``aniso``,
``sa``, ``cheby`` (256^3), ``mg``, ``gmg-tri``, ``gmg-w``, ``gmg-cheby``
(256^3) and ``cli``, each with its own eager twin, through
``chip_smoke``'s drivers.  Then round 0: ``effective_diffusivity`` (eps
1e-9, lanes where the gate admits them) graphed, the ``lanes=False`` call
``main[deff]`` makes, and the eager twin (``graphs._eager_twin``).  Then
it loops the graphed call and its eager twin, one ``tortuosity`` (the
``iso`` call) between rounds, for at least ``--rounds`` rounds and until
``--minutes`` have passed (at most ``--max-rounds``).  What varies from
round to round: every other round empties the allocator's cache before
the graphed call, every fifth runs the eager twin first.

``--stress`` holds K1 alone against itself instead, after the kernels'
build: ``--rounds`` launches of each mode and route on the periodic cell
problem while a thread maps and unmaps device memory (``_stress``).  This
is how a missing proxy fence in K1's stream route showed: without it some
periodic ``sweep``/``resid`` launches came out different under the churn.

Each round records, for both calls: the tensor's and the per-lane
rel_res's bits (``float.hex``), the iterations, the per-lane residual
history (``return_history``), K1's launches by route and extent
(``stencil_cuda.launches_route_at``) and ``graphs.stats``; a round whose
two calls differ in any of the bits prints both histories up to the first
chunk where they differ.  Prints the card's name and power limit first and
a summary JSON object last; ``--out`` gets every round.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs
from openimpala_tpu_torch import effective_diffusivity, tortuosity
from openimpala_tpu_torch.ops import stencil_cuda as sc
from openimpala_tpu_torch.solve import warmup
from openimpala_tpu_torch.utils import graphs
from openimpala_tpu_torch.utils.sample_data import make_blobs

# the main paths chip_smoke.py drives before main[deff], in its order
BEFORE_DEFF = ("iso", "aniso", "sa", "cheby", "mg", "gmg-tri", "gmg-w",
               "gmg-cheby", "cli")


def _hex(values) -> list:
    return [float(v).hex() for v in np.asarray(values, np.float64).ravel()]


def _routes() -> dict:
    return {f"{k} {route} {'x'.join(map(str, shp))}": v
            for (k, route, shp), v in sorted(sc.launches_route_at.items())}


def _deff(vol, eager: bool, lanes="auto") -> dict:
    """One ``effective_diffusivity`` call, counted on its own."""
    torch.cuda.synchronize()
    sc.reset_counts()
    graphs.reset_stats()
    t0 = time.perf_counter()
    if eager:
        with graphs._eager_twin():
            res = effective_diffusivity(vol, 1, eps=1e-9, device="cuda",
                                        lanes=lanes, return_history=True)
    else:
        res = effective_diffusivity(vol, 1, eps=1e-9, device="cuda",
                                    lanes=lanes, return_history=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    hist = res.history[0] if res.lanes else None
    return {"eager": eager, "lanes": res.lanes, "wall_s": wall,
            "deff": _hex(res.deff), "rel_res": _hex(res.rel_res),
            "iterations": list(res.iterations),
            "inner": None if hist is None else [
                (it, _hex(rel)) for it, rel in hist.inner],
            "outer": None if hist is None else [
                (rd, _hex(rel)) for rd, rel in hist.outer],
            "k1_routes": _routes(), "graph": dict(graphs.stats)}


def _first_difference(a: dict, b: dict):
    """The first inner chunk where two calls' per-lane residuals differ,
    and both histories up to it (None where they agree)."""
    for i, (ga, gb) in enumerate(zip(a["inner"] or [], b["inner"] or [])):
        if ga != gb:
            return {"chunk": i, "graphed": a["inner"][:i + 1],
                    "eager": b["inner"][:i + 1]}
    return None


def _same(a: dict, b: dict) -> bool:
    return all(a[k] == b[k] for k in ("deff", "rel_res", "iterations"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--minutes", type=float, default=20.0)
    ap.add_argument("--max-rounds", type=int, default=400)
    ap.add_argument("--skip-kernels", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--stress", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_lanes_repro: no CUDA device", flush=True)
        return 2
    if args.stress:
        return _stress(args)
    t_start = time.perf_counter()
    cs._RAW["dir"] = tempfile.mkdtemp(prefix="lanes_repro_")
    warm = warmup.SolverWarmup(tuple(sc.SOURCES), torch.device("cuda"))
    vol = make_blobs(args.n, 0.4, cs.SEED)
    cs.phase_card(warm)
    if not args.skip_kernels:
        cs.phase_kernels(cs.Checker(), cs.SEED)
    runs = {}
    for label in BEFORE_DEFF:
        kind, dx, precond, opts, _ = cs.PATHS[label]
        if label == "cheby":
            runs[label] = cs._drive_cheby(label, vol, args.n, dx, precond,
                                          runs)
        elif label == "mg":
            runs[label] = cs._drive_mg(label, vol, args.n, dx, precond,
                                       None, opts)
        elif opts:
            runs[label] = cs._drive_option(label, vol, args.n, dx, precond,
                                           None, opts)
        elif kind == "cli":
            runs[label] = cs._drive_cli(label, vol, args.n)
        else:
            runs[label] = cs._drive_tau(label, vol, args.n, dx, precond)
    cs.log(f"repro: the main paths before deff ran in "
           f"{time.perf_counter() - t_start:.1f} s")

    rounds, t_loop = [], time.perf_counter()
    i = 0
    while i < args.max_rounds and (
            i < args.rounds or time.perf_counter() - t_loop
            < args.minutes * 60):
        variant = {"empty_cache": i % 2 == 1, "eager_first": i % 5 == 4}
        if i > 0:
            tortuosity(vol, 1, "X", eps=1e-9, device="cuda")
        if variant["empty_cache"]:
            torch.cuda.empty_cache()
        if variant["eager_first"]:
            eager = _deff(vol, True)
            graphed = _deff(vol, False)
        else:
            graphed = _deff(vol, False)
            if i == 0:  # main[deff]'s lanes=False call
                _deff(vol, False, lanes=not graphed["lanes"])
            eager = _deff(vol, True)
        same = _same(graphed, eager)
        row = {"round": i, "variant": variant, "same": same,
               "graphed": graphed, "eager": eager}
        if not same:
            row["first_difference"] = _first_difference(graphed, eager)
        rounds.append(row)
        cs.log(f"repro round {i} {json.dumps(variant)}: same={same} "
               f"graphed rel_res={graphed['rel_res']} "
               f"eager rel_res={eager['rel_res']} iterations="
               f"{graphed['iterations']}/{eager['iterations']} walls "
               f"{graphed['wall_s']:.3f}/{eager['wall_s']:.3f} graph "
               f"{json.dumps(graphed['graph'])}")
        if not same:
            cs.log("repro DIFFERENCE " + json.dumps(row["first_difference"])
                   + " routes graphed " + json.dumps(graphed["k1_routes"])
                   + " eager " + json.dumps(eager["k1_routes"]))
        i += 1
    differing = [r["round"] for r in rounds if not r["same"]]
    summary = {"rounds": len(rounds), "differing": differing,
               "loop_s": time.perf_counter() - t_loop,
               "total_s": time.perf_counter() - t_start,
               "card": cs.card_line()}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "rounds": rounds}, f)
    cs.log(json.dumps(summary))
    return 0


def _stress(args) -> int:
    """K1 alone on one ``--n``^3 periodic cell problem (direction Y): each
    mode (``sweep``, ``resid``, ``matvec`` with the fused dot) on each
    route, ``--rounds`` launches on the same inputs while a thread
    allocates and frees device memory, each output held against a quiet
    launch's bit for bit; logs how many differ."""
    import threading

    from openimpala_tpu_torch.ops.stencil import make_cell_problem_system

    warm = warmup.SolverWarmup(tuple(sc.SOURCES), torch.device("cuda"))
    vol = make_blobs(args.n, 0.4, cs.SEED)
    cs.phase_card(warm)
    dev = torch.device("cuda")
    system = make_cell_problem_system(torch.from_numpy(vol == 1).to(dev), 1,
                                      dtype=torch.float32)
    code, w, per = system.code, system.w, system.periodic
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(tuple(code.shape), generator=gen, device=dev)
    r = torch.randn(tuple(code.shape), generator=gen, device=dev)
    stop = threading.Event()

    def churn():
        while not stop.is_set():
            a = torch.empty(1 << 28, device=dev)
            del a
            torch.cuda.empty_cache()

    results = {}
    for route in ("stream", "general"):
        for mode in ("sweep", "resid", "matvec"):
            def k1():
                if mode == "matvec":
                    return sc.k1_stencil("matvec", x, None, code, w, per,
                                         with_dot=True, route=route)
                return (sc.k1_stencil(mode, x, r, code, w, per,
                                      route=route),)
            ref = tuple(t.clone() for t in k1())
            stop.clear()
            thread = threading.Thread(target=churn)
            thread.start()
            try:
                bad = sum(not all(torch.equal(a, b)
                                  for a, b in zip(k1(), ref))
                          for _ in range(args.rounds))
            finally:
                stop.set()
                thread.join()
            results[f"{route} {mode}"] = bad
            cs.log(f"stress {route} {mode}: {bad} of {args.rounds} differ")
    cs.log(json.dumps({"card": cs.card_line(), "rounds": args.rounds,
                       "differing": results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
