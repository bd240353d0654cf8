"""One run of one cell: set-up, the measured window, the traced
sub-window, the comparison with the reference, and the result line.

The window is a closed loop with one client: the next request goes out
only once the last answer is in host memory.  Requests go out until
``--seconds`` have passed; the window closes when the last answer
arrives.  Nothing is built or captured for the first time inside it: the
set-up made one request of the cell's shape along every direction the
stream uses.  A cell of several cards runs one rank per card
(``ranks.py``), each on its own X slab of every volume; this process is
rank 0 and keeps the clock.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import subprocess
import sys
import tempfile
import time

import numpy as np

from . import blobs, devtrace, ranks, spec
from . import traffic as traffic_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "openimpala_tpu")


@dataclasses.dataclass
class Window:
    """What the end-to-end readers read."""

    kind: str
    seconds: float
    latencies: list  # seconds from call to answer, every request
    results: int  # tau values or tensors completed
    peak_bytes: int
    setup_s: float
    flushes: int | None = None  # the allocator's cache flushes in it


@dataclasses.dataclass
class Traced:
    """What the per-layer readers read: one entry per traced request
    (``timings``, ``graphs``: the package's graph statistics, ``launches``:
    its K1 launches by (name, route, extent)) and the trace's reduction."""

    kind: str
    answers: list
    trace: dict
    window: Window | None = None  # the measured window before it


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line(torch) -> str:
    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as exc:
        limit = [f"nvidia-smi: {exc}"]
    return (f"card: {name} x{torch.cuda.device_count()}; power limit "
            f"{'; '.join(limit)}")


def _read(entries, group, what, root):
    """Each metric's reader on ``what``; a metric it finds nothing for is
    left out."""
    out = {}
    for m in entries:
        v = spec.reader(group, m["name"], root)(what)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def _flushes(torch):
    """How often the caching allocator has emptied its cache (each
    ``torch.cuda.empty_cache()``, and each flush after a failed cudaMalloc,
    synchronises and frees its events once); None where it does not
    count them."""
    return torch.cuda.memory_stats().get("num_sync_all_streams")


def _sync(torch, device):
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, t0: float, port=None, root: str = spec.ROOT) -> dict:
    """The result of one run (the dict printed as the last line);
    ``port``: the package under test (for a cell on several cards, its
    ``ranks.resolve_port`` name, which every rank builds), ``root``: the
    checkout whose readers it reads.  A cell on several cards runs on as
    many ranks (``ranks.py``)."""
    if cell.chips == 1:
        return _run(cell, seed, seconds, trace, device, t0, port, root,
                    None)
    import torch

    world = ranks.World(cell.chips, device)
    threads = torch.get_num_threads()
    if not world.cuda:  # ranks that share the host's cores: one each
        torch.set_num_threads(1)
    try:
        return _run(cell, seed, seconds, trace, device, t0, port, root,
                    world)
    except BaseException as exc:
        world.abandon()
        world.check(exc)
        raise
    finally:
        torch.set_num_threads(threads)


def _run(cell, seed, seconds, trace, device, t0, port, root, world):
    import torch

    spec_name = port if isinstance(port, str) else ranks.PORT
    if isinstance(port, str):
        port = ranks.resolve_port(port)
    if port is None:
        import openimpala_tpu_torch as port
    from openimpala_tpu_torch.ops import stencil_cuda
    from openimpala_tpu_torch.utils import graphs

    cuda = str(device).startswith("cuda")
    traffic = traffic_mod.make(cell.traffic, seed)
    kind = importlib.import_module(f"portbench.kinds.{traffic.kind}")
    config = cell.config
    # made on the device, handed to the package as host arrays
    s0 = time.perf_counter()
    volumes = [blobs.blobs(traffic.n, p, s, device).cpu().numpy()
               for p, s in zip(traffic.porosities, traffic.volume_seeds)]
    s1 = time.perf_counter()
    workdir = None
    if hasattr(kind, "prepare"):
        if world is not None:
            raise NotImplementedError(
                f"kind {traffic.kind!r} prepares files: one card only")
        # what the requests read (files), made before the warm-up in a
        # directory removed once the traced requests are answered (on a
        # failure, when the object goes)
        workdir = tempfile.TemporaryDirectory(prefix="portbench-")
        feed, extra = kind.prepare(volumes, config, traffic, workdir.name), {}
        print(f"portbench: prepare {time.perf_counter() - s1:.3f} s",
              file=sys.stderr, flush=True)
    elif world is None:
        feed, extra = volumes, {}
    else:
        # every rank its own X slab, as io.ingest.threshold_sharded hands
        # it (the edge divides into the ranks: no padding)
        world.join({"cell": dataclasses.asdict(cell), "seed": seed,
                    "port": spec_name, "device": "cuda" if cuda else "cpu"})
        feed = world.scatter(volumes)
        extra = {"original_shape": (traffic.n,) * 3}
        print(f"portbench: {world.n} ranks ({world.backend}) joined and "
              f"given their slabs {time.perf_counter() - s1:.3f} s after "
              f"the volumes", file=sys.stderr, flush=True)

    def call(req, **kw):
        if world is not None:
            world.tell(ranks.CALL, req.index)
        ans = kind.call(port, feed[req.volume], req, config, device,
                        **extra, **kw)
        if world is not None:
            world.done()
        return ans

    for req in traffic.warmup(seed):
        call(req)
    _sync(torch, device)
    if world is not None:
        world.tell(ranks.WARMED)
        world.done()
    print(f"portbench: set-up: imports and device {s0 - t0:.3f} s, volumes "
          f"{s1 - s0:.3f} s, warm-up {time.perf_counter() - s1:.3f} s",
          file=sys.stderr, flush=True)
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    answered, latencies = [], []
    flush0 = _flushes(torch) if cuda else None
    start = time.perf_counter()
    setup_s = start - t0
    i = 0
    while True:
        req = traffic.request(i, seed)
        i += 1
        a0 = time.perf_counter()
        ans = call(req)
        a1 = time.perf_counter()
        answered.append((req, ans))
        latencies.append(a1 - a0)
        if a1 - start >= seconds:
            break
    flushes = None if flush0 is None else _flushes(torch) - flush0
    third = max(1, len(latencies) // 3)
    # the caching allocator's flushes (a failed cudaMalloc frees the cache
    # and retries; so does the package's graph capture when it runs out)
    # and what it holds at the close
    alloc = (f"; allocator retries "
             f"{torch.cuda.memory_stats().get('num_alloc_retries', 0)}"
             f", cache flushes in the window {flushes}"
             f", reserved {torch.cuda.memory_reserved() / 1e9:.2f} GB"
             if cuda else "")
    print(f"portbench: setup {setup_s:.3f} s, window {a1 - start:.3f} s, "
          f"{len(answered)} requests; latency s median "
          f"{np.median(latencies):.4f}, p95 {np.percentile(latencies, 95):.4f}"
          f", max {max(latencies):.4f} (request {int(np.argmax(latencies))})"
          f"; median of the first and last third "
          f"{np.median(latencies[:third]):.4f}, "
          f"{np.median(latencies[-third:]):.4f}{alloc}", file=sys.stderr,
          flush=True)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if world is not None:  # the fullest card
        peaks = [r["peak_bytes"] for r in world.gather(ranks.CLOSED)]
        print(f"portbench: peak GB by rank "
              f"{[round(b / 1e9, 3) for b in [peak] + peaks]}",
              file=sys.stderr, flush=True)
        peak = max([peak] + peaks)
    window = Window(traffic.kind, a1 - start, latencies,
                    sum(kind.results(a) for _, a in answered), peak,
                    setup_s, flushes)
    attempted = sum(kind.expected(r, traffic) for r, _ in answered)
    failed = sum(kind.failed(r, a, traffic) for r, a in answered)

    metrics = _read(cell.end_to_end, "end_to_end", window, root)
    device_info = {"platform": "gpu" if cuda else str(device),
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": window.peak_bytes}
    breakdown = None
    if trace:
        from torch.profiler import record_function

        rows = []
        if world is not None:
            from openimpala_tpu_torch.parallel import mesh as port_mesh
            # every rank's profiler records before the first request
            world.gather(ranks.TRACE_ON)
        with devtrace.traced() as reduced:
            for j in range(int(traffic.trace["answers"])):
                req = traffic.request(i + j, seed)
                graphs.reset_stats()
                stencil_cuda.reset_counts()
                if world is not None:
                    port_mesh.reset_stats()
                timings = {}
                with record_function(devtrace.ANSWER):
                    call(req, timings=timings)
                    _sync(torch, device)
                rows.append({"timings": timings, "graphs": dict(graphs.stats),
                             "launches": dict(stencil_cuda.launches_route_at)})
                if world is not None:
                    rows[-1]["mesh"] = dict(port_mesh.stats)
        if world is not None:
            # each rank traced its own card: the busy seconds are their
            # mean, the window rank 0's
            busy = [r.get("busy_s") for r in world.gather(ranks.TRACE_OFF)]
            if reduced:
                busy = [reduced["busy_s"]] + busy
                print(f"portbench: traced busy s by rank {busy}",
                      file=sys.stderr, flush=True)
                reduced["busy_s"] = sum(busy) / len(busy)
        print(f"portbench: traced {len(rows)} requests, "
              f"{time.perf_counter() - a1:.3f} s after the window",
              file=sys.stderr, flush=True)
        metrics = _read(cell.per_layer, "metrics",
                        Traced(traffic.kind, rows, reduced, window), root)
        if reduced:
            device_info["busy_s"] = reduced["busy_s"]
            device_info["window_s"] = reduced["window_s"]
            breakdown = {"device_ops": reduced["device_ops"],
                         "idle_gaps": reduced["idle_gaps"]}

    if world is not None:
        # the other ranks end before the reference takes their cards
        reports = world.close()
        for r, rep in enumerate(reports, 1):
            if rep["log"].strip():
                print(f"portbench: rank {r} printed:\n{rep['log'].strip()}",
                      file=sys.stderr, flush=True)
        found = sorted({m for rep in reports for m in rep["forbidden"]})
        if found:
            raise RuntimeError(f"a rank loaded {', '.join(found)}")
    if workdir is not None:
        workdir.cleanup()
    # the program's state is gone (answers are host values); the reference
    # runs on the device in f64, after the peak was read
    if cuda:
        torch.cuda.empty_cache()
    rng = np.random.default_rng(blobs.seed_of(seed, traffic_mod.CHECK))
    c0 = time.perf_counter()
    readings = kind.compare(answered, volumes, config, traffic, rng,
                            ranks.devices(device, cell.chips), torch.float64)
    print(f"portbench: reference {time.perf_counter() - c0:.3f} s",
          file=sys.stderr, flush=True)
    limits = traffic.check["limits"]
    checks = {"failed": {"value": failed, "limit": 0}}
    checks.update({k: {"value": v, "limit": limits[k]}
                   for k, v in readings.items()})
    correct = set(readings) == set(limits) and all(
        c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def main(t0: float, argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.cell(spec.load(), args.workload)

    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"portbench: the cell needs {cell.chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    print(card_line(torch), file=sys.stderr, flush=True)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   t0)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 4
    print(f"correct: {out['correct']}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
