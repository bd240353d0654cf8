#!/usr/bin/env python3
"""The slab V-cycle's coarsest Chebyshev solve, gathered against on the
ranks' slabs, on one rank per card.

    python3 -m scripts.slab_coarse_crossover [--ranks 4] [--n 256 512 1024]
        [--repeat 20] [--out chiprun_out/slab_coarse.json]

(from the repo root, on a machine with ``--ranks`` cards; ``nccl``)

For each fine size N every rank builds the flow-through system of its X
slab of a random N^3 mask (porosity 0.7, float32, the PCG's working
dtype) and the default cycle twice: ``SlabGalerkinMGPreconditioner`` with
``slab_mg.SLAB_COARSE_MIN_CELLS`` at 0 (the coarsest level on the slabs)
and above any volume (gathered).  It times, after a warm-up, ``--repeat``
coarsest solves of each from one random coarse residual, on the slabs as
the program runs them (one CUDA graph) and eagerly (``graphs.
_eager_twin``): the wall per solve (ended by a synchronise), the host's
time to issue one, and per step; the largest difference of each from the
gathered solve; K2's cheby step alone at the padded
slab's extent and at the global coarsest extent (CUDA events over back-
to-back launches: the device's time per step), the prepared ghost
exchange alone; and one whole V-cycle of each with their largest
difference.  Rank 0 prints one JSON object per size (also to its log,
``slab_coarse_ranks/rank0.log`` beside ``--out``, as each size ends) and
writes every rank's list to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from openimpala_tpu_torch.ops import stencil_cuda
from openimpala_tpu_torch.ops.stencil import make_tortuosity_system
from openimpala_tpu_torch.parallel import spawn
from openimpala_tpu_torch.solve import slab_mg
from openimpala_tpu_torch.solve.refine import make_precond
from openimpala_tpu_torch.utils import graphs


def _wall(mesh, fn, repeat: int):
    """(wall ms per call ended by a synchronise, host ms to issue one)."""
    mesh.barrier()
    torch.cuda.synchronize()
    issue = 0.0
    t0 = time.perf_counter()
    for _ in range(repeat):
        a = time.perf_counter()
        fn()
        issue += time.perf_counter() - a
    torch.cuda.synchronize()
    return ((time.perf_counter() - t0) * 1e3 / repeat, issue * 1e3 / repeat)


def _events_us(fn, repeat: int):
    """Device microseconds per call of back-to-back calls (CUDA events)."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(repeat):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / repeat


def _build(sys_, min_cells: int):
    saved = slab_mg.SLAB_COARSE_MIN_CELLS
    slab_mg.SLAB_COARSE_MIN_CELLS = min_cells
    try:
        return make_precond(sys_, "gmg", {})
    finally:
        slab_mg.SLAB_COARSE_MIN_CELLS = saved


def rank(mesh, sizes, repeat: int):
    out = []
    for n in sizes:
        stencil_cuda.reset_counts()
        xl = n // mesh.size
        gen = torch.Generator(device=mesh.device)
        gen.manual_seed(1000 * n + mesh.rank)
        active = torch.rand((xl, n, n), generator=gen,
                            device=mesh.device) < 0.7
        sys_ = make_tortuosity_system(active, 0, -1.0, 1.0,
                                      dtype=torch.float32, mesh=mesh)
        del active
        slabs = _build(sys_, 0)
        gathered = _build(sys_, 1 << 62)
        assert slabs.gather is None and gathered.gather is not None
        coarse = slabs.levels[-1]
        steps = slabs.coarse_sweeps - 1
        rc = torch.randn(coarse.diag.shape, generator=gen,
                         device=mesh.device) * coarse.free
        k = len(slabs.levels)

        def on_slabs():
            return slabs._vcycle(k, rc)

        def eager():
            with graphs._eager_twin():
                return slabs._vcycle(k, rc)

        def gather():
            return gathered._vcycle(gathered.gather, rc)

        modes = (("slabs", on_slabs), ("slabs_eager", eager),
                 ("gathered", gather))
        for _ in range(3):
            for _, fn in modes:
                fn()
        same = {name: float((fn() - gather()).abs().max())
                for name, fn in modes[:2]}
        rows = {}
        for name, fn in modes + modes:
            wall, issue = _wall(mesh, fn, repeat)
            rows.setdefault(name, []).append((wall, issue))
        best = {name: min(r) for name, r in rows.items()}
        # the slab step's parts alone: K2 at the padded extent, the exchange
        res, d, x = coarse.cheby_init(rc, 0.5)
        _, _, launch, fill = coarse._solve[0].steps[0]  # d's bound step
        pk = coarse.padded
        k2_slab_us = _events_us(lambda: launch(0.5, 0.1), 200)
        exch_ms, _ = _wall(mesh, fill, 200)
        glev = gathered.glob.levels[-1]
        gres, gd, gx = glev.cheby_init(mesh.all_gather_x(rc), 0.5)
        gspare = torch.empty_like(gd)
        k2_glob_us = _events_us(lambda: glev.cheby_step(
            gres, gd, gx, 0.5, 0.1, out=gspare), 200)
        # one whole V-cycle of each
        r = torch.randn(sys_.code.shape, generator=gen,
                        device=mesh.device) * sys_.free
        vc = {}
        for name, M in (("slabs", slabs), ("gathered", gathered),
                        ("slabs", slabs), ("gathered", gathered)):
            wall, _ = _wall(mesh, lambda: M(r), 5)
            vc[name] = min(vc.get(name, wall), wall)
        diff = float((slabs(r) - gathered(r)).abs().max())
        diff = float(mesh.allmax(torch.tensor(diff, device=mesh.device)))
        out.append({
            "n": n, "coarsest": [int(v) for v in glev.diag.shape],
            "slab_padded": [int(v) for v in pk.diag.shape],
            "steps": steps,
            "solve_ms": {k_: v[0] for k_, v in best.items()},
            "issue_ms": {k_: v[1] for k_, v in best.items()},
            "runs_ms": rows,
            "coarse_max_diff": same,
            "eager_host_us_per_step": best["slabs_eager"][1] * 1e3 / steps,
            "eager_wall_us_per_step": best["slabs_eager"][0] * 1e3 / steps,
            "graphed_wall_us_per_step": best["slabs"][0] * 1e3 / steps,
            "k2_us": {"slab": k2_slab_us, "global": k2_glob_us},
            "exchange_us": exch_ms * 1e3,
            "vcycle_ms": vc, "vcycle_max_diff": diff,
            "launches_at_k2": {f"{a}@{list(s)}": c for (a, s), c in
                               stencil_cuda.launches_at.items()
                               if a.startswith("k2_cheby")},
        })
        if mesh.rank == 0:
            print(json.dumps(out[-1]), flush=True)
        del slabs, gathered, sys_, res, d, x, gres, gd, gx, gspare, r
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--n", type=int, nargs="+", default=[256, 512, 1024])
    ap.add_argument("--repeat", type=int, default=20)
    ap.add_argument("--out", default="chiprun_out/slab_coarse.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs CUDA cards: one per rank")
    card = torch.cuda.get_device_name(0)
    got = spawn.run("scripts.slab_coarse_crossover:rank", args.ranks,
                    args=(args.n, args.repeat), backend="nccl",
                    device="cuda", timeout=1200,
                    workdir=os.path.join(os.path.dirname(
                        os.path.abspath(args.out)), "slab_coarse_ranks"))
    rows = got[0]
    for row in rows:
        row["card"] = card
        row["ranks"] = args.ranks
        print(json.dumps(row), flush=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "ranks": args.ranks, "by_rank": got}, f,
                  indent=1)


if __name__ == "__main__":
    main()
