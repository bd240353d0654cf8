#!/usr/bin/env python3
"""Where the time of the port's solves goes on one NVIDIA GPU.

    python3 -m scripts.profile_torch_solve [--n 512] [--precond sa]
        [--precond-opts '{"cycle": "w", "coeff_dtype": "bfloat16"}']
        [--entry tortuosity|deff|rev] [--lanes auto|true|false] [--eager]
        [--in-flight 0 1 2] [--wait spin block] [--repeat 5] [--rounds 3]

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
The solvers' PCG iterations run as CUDA graphs, as the entry points run
them (``utils/graphs.py``); ``--eager`` profiles the eager twin instead
(``graphs._eager_twin``).  ``--in-flight`` and ``--wait`` profile the call
once for each pair of their values (in that order, after one warm-up):
the steps a graphed PCG loop keeps enqueued behind the one whose probe the
host reads (``graphs.IN_FLIGHT``) and how the host waits for a probe
(``graphs.BLOCKING_WAIT``), with the iterations the loops counted and
executed; ``--repeat R`` times R calls of each without the profiler
first, and ``--rounds N`` runs the whole sweep N times in turns, closed
by each setting's medians.  The device's idle milliseconds are the wall
less the busy time; inside the PCG loops (each call of ``LOOPS`` marked
as a profiler range) they are the loops' host wall less the device's
busy time within it.
The script runs an older tree of the package too (from that tree's root,
where ``IN_FLIGHT`` and ``--in-flight`` do not exist).  Each profiled
call prints its table and one JSON object; the last line is one JSON
object with every call's numbers.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import itertools
import json
import statistics
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

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
                    help="run the solvers' steps eagerly (the twin of the "
                         "graphed run)")
    ap.add_argument("--in-flight", type=int, nargs="+", default=[None],
                    help="graphs.IN_FLIGHT values to profile in turn "
                         "(default: the package's)")
    ap.add_argument("--wait", nargs="+", choices=("spin", "block"),
                    default=[None],
                    help="how the host waits for a probe, in turn "
                         "(default: the package's)")
    ap.add_argument("--rounds", type=int, default=1,
                    help="profile every setting this many times, in turns")
    ap.add_argument("--repeat", type=int, default=0,
                    help="calls timed without the profiler before each "
                         "profiled one (host clock, synchronised)")
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

    def mode():
        return graphs._eager_twin() if args.eager else \
            contextlib.nullcontext()

    with mode():
        run()  # build kernels, warm up
    out = []
    for _, in_flight, wait in itertools.product(
            range(args.rounds), args.in_flight, args.wait):
        if in_flight is not None:
            graphs.IN_FLIGHT = in_flight
        if wait is not None:
            graphs.BLOCKING_WAIT = wait == "block"
        walls = []
        with mode():
            for _ in range(args.repeat):
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            row = _profiled(run, args, card, wait, lanes_ran)
        if walls:
            row["unprofiled_wall_s"] = sorted(walls)
            print(f"IN_FLIGHT={row['in_flight']} wait={wait}: {len(walls)} "
                  f"calls without the profiler, wall s median "
                  f"{statistics.median(walls):.4f} min {min(walls):.4f}")
        out.append(row)
    summary = _summary(out)
    for row in summary:
        print("median of " + json.dumps(row))
    print(json.dumps({"card": card, "calls": out, "summary": summary}))
    return 0


def _summary(calls):
    """Per (IN_FLIGHT, wait): the medians over the rounds of the device's
    idle ms inside the PCG loops, that idle per executed step, the busy
    ms and the call's wall, and the median unprofiled wall."""
    groups = {}
    for c in calls:
        groups.setdefault((c["in_flight"], c["wait"]), []).append(c)
    out = []
    for (in_flight, wait), cs in groups.items():
        med = lambda f: statistics.median(f(c) for c in cs)  # noqa: E731
        walls = [w for c in cs for w in c.get("unprofiled_wall_s", [])]
        out.append({
            "in_flight": in_flight, "wait": wait, "profiled_calls": len(cs),
            "pcg_loop_device_idle_ms": med(
                lambda c: c["pcg_loop_device_idle_ms"]),
            "pcg_loop_idle_us_per_step": med(
                lambda c: 1e3 * c["pcg_loop_device_idle_ms"]
                / max(1, c["graphs"].get("steps") or c["graphs"]["replays"]
                      + c["graphs"]["captures"])),
            "device_busy_ms": med(lambda c: c["device_busy_ms"]),
            "profiled_wall_s": med(lambda c: c["wall_s"]),
            "unprofiled_calls": len(walls),
            "unprofiled_wall_s": statistics.median(walls) if walls else None})
    return out


# the PCG loops (module, function names), each marked as a profiler range
# while a profiled call runs: the mono loop, the lanes' entry to it
# (``cg_lanes`` calls ``_cg_loop`` through its own module's import, so a
# lockstep solve is marked once) and the batched loop
LOOPS = (("openimpala_tpu_torch.solve.cg", ("_cg_loop",)),
         ("openimpala_tpu_torch.solve.lanes", ("cg_lanes",)),
         ("openimpala_tpu_torch.solve.batched", ("_batched_cg",)))


@contextlib.contextmanager
def _marked_loops():
    """Wrap each PCG loop of ``LOOPS`` in a ``pcg_loop`` profiler range
    (its callers look it up in its module at each call)."""
    saved = []
    for name, fns in LOOPS:
        mod = importlib.import_module(name)
        for fn in fns:
            if hasattr(mod, fn):
                saved.append((mod, fn, getattr(mod, fn)))
    for mod, fn, f in saved:
        def marked(*a, _f=f, **k):
            with record_function("pcg_loop"):
                return _f(*a, **k)
        setattr(mod, fn, marked)
    try:
        yield
    finally:
        for mod, fn, f in saved:
            setattr(mod, fn, f)


def _loop_idle(prof):
    """(host ms inside the PCG loops, device-busy ms inside them, loops):
    the union of the device's kernel and copy intervals clipped to the
    ``pcg_loop`` ranges."""
    loops, dev = [], []
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end)
        if e.name == "pcg_loop":  # the device's copy of a range is no work
            if e.device_type == DeviceType.CPU:
                loops.append(span)
        elif e.device_type == DeviceType.CUDA:
            dev.append(span)
    merged = []
    for a, b in sorted(dev):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(max(0, min(b, lb) - max(a, la))
               for la, lb in loops for a, b in merged)
    return (sum(lb - la for la, lb in loops) / 1e3, busy / 1e3, len(loops))


def _profiled(run, args, card, wait, lanes_ran):
    """One call of ``run`` under the profiler: its tables, and its numbers
    as one JSON object (printed and returned)."""
    graphs.reset_stats()
    timings = {}
    with _marked_loops(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        iterations, what = run(timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    gstats = dict(graphs.stats)
    loop_ms, loop_busy_ms, n_loops = _loop_idle(prof)
    print(f"PCG loops: {n_loops} calls, {loop_ms:.1f} ms of host wall, the "
          f"device busy {loop_busy_ms:.1f} ms of it (idle "
          f"{loop_ms - loop_busy_ms:.1f} ms)")
    print(f"steps {'eager' if args.eager else 'graphed'}, IN_FLIGHT="
          f"{getattr(graphs, 'IN_FLIGHT', None)}, wait={wait}: "
          + json.dumps(gstats))
    print(f"entry={args.entry} precond={args.precond} "
          f"opts={args.precond_opts} {what} iterations={iterations} "
          f"wall_s={wall:.3f} (under the profiler)")
    print("step_s " + json.dumps({k: round(v, 4) for k, v in timings.items()}))

    rows = []
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.key != "pcg_loop" and evt.device_type is not None \
                and "cuda" in str(evt.device_type).lower():
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
    row = {
        "card": card, "n": args.n, "entry": args.entry,
        "precond": args.precond,
        "precond_opts": args.precond_opts, "iterations": iterations,
        "eager": args.eager, "in_flight": getattr(graphs, "IN_FLIGHT", None),
        "wait": wait, "graphs": gstats, "device_idle_ms": wall * 1e3 - busy_ms,
        "pcg_loops": n_loops, "pcg_loop_ms": loop_ms,
        "pcg_loop_device_busy_ms": loop_busy_ms,
        "pcg_loop_device_idle_ms": loop_ms - loop_busy_ms,
        "lanes": lanes_ran[0] if lanes_ran else None,
        "wall_s": wall, "steps_s": timings, "device_busy_ms": busy_ms,
        "hand_kernels_ms": hand_ms, "torch_kernels_ms": busy_ms - hand_ms,
        "top": [{"name": k[:100], "launches": c, "ms": u / 1e3}
                for k, c, u in rows[:20]]}
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    sys.exit(main())
