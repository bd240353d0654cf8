#!/usr/bin/env python3
"""The ranks of a cell that asks for more than one card: one process per
card, joined as ``torch.distributed.run`` joins them (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), so that
the package under test finds its process group itself (``mesh="auto"``).

The harness's process is rank 0: it keeps the window's clock, the stream
of requests, the comparison and the result line.  It starts the other
ranks as ``python3 portbench/ranks.py <backend>`` and, before each step
of the run, tells them over a ``gloo`` group of their own (off the
package's ``nccl`` stream) what comes next: a request by its index, the
end of the warm-up, the window's close, the traced sub-window's start
and end, or the stop.  Every rank makes the same calls on its own X slab
of the same volumes, which rank 0 makes and sends to each.

A rank that raises prints its traceback and exits; a rank that exits, or
does not answer within ``TIMEOUT_S`` seconds, ends the run: rank 0 stops
every other rank and fails.  Under ``nccl`` rank 0's process then exits
with 5, since a collective of ``nccl`` does not notice a lost peer; under
``gloo`` (the CPU) the lost peer breaks rank 0's collective, and the run
raises.  A rank whose rank 0 is gone exits too.  No rank may load a module of
``harness.FORBIDDEN``: each checks once the window has closed.
"""

from __future__ import annotations

import datetime
import importlib
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import traceback

if __name__ == "__main__":  # a rank: import from the checkout's root
    _HERE = os.path.dirname(os.path.abspath(__file__))
    sys.path = [os.path.dirname(_HERE)] + [
        p for p in sys.path if os.path.abspath(p or ".") != _HERE]

import numpy as np  # noqa: E402

CALL, WARMED, CLOSED, TRACE_ON, TRACE_OFF, STOP = range(6)
# a step's limit: a warm-up request builds the package's kernels first
TIMEOUT_S = 300.0
SCRIPT = os.path.abspath(__file__)
PORT = "openimpala_tpu_torch"


def resolve_port(spec: str):
    """The package under test from ``"module"`` or ``"module:factory"``
    (a function that returns an object with the entry points)."""
    module, _, factory = spec.partition(":")
    mod = importlib.import_module(module)
    return getattr(mod, factory)() if factory else mod


def devices(device, n: int):
    """The device of each of ``n`` slabs: ``device`` itself for one, the
    first ``n`` CUDA devices, or the CPU ``n`` times."""
    if n == 1:
        return device
    if str(device).startswith("cuda"):
        return tuple(f"cuda:{k}" for k in range(n))
    return (str(device),) * n


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dist():
    import torch.distributed as dist
    return dist


class World:
    """Rank 0's side of a run on ``n`` ranks: made, it starts the others;
    ``join`` makes the groups and hands them the job, ``scatter`` their
    slabs; ``tell`` and ``gather`` drive them; ``close`` stops them and
    returns what each reported, ``abandon`` stops them on a failure."""

    def __init__(self, n: int, device):
        self.n, self.device = n, str(device)
        self.cuda = self.device.startswith("cuda")
        self.backend = "nccl" if self.cuda else "gloo"
        self.timeout = TIMEOUT_S
        self.dir = tempfile.mkdtemp(prefix="portbench_ranks_")
        self.port = _free_port()
        self.procs, self.failure, self.deadline = [], None, None
        self.closing, self.side = False, None
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(self.port), WORLD_SIZE=str(n),
                   LOCAL_WORLD_SIZE=str(n))
        for r in range(1, n):
            with open(os.path.join(self.dir, f"rank{r}.log"), "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, SCRIPT, self.backend],
                    env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                    stdout=log, stderr=subprocess.STDOUT,
                    stdin=subprocess.DEVNULL))
        self.deadline = time.monotonic() + self.timeout
        self._stop = threading.Event()
        self._watch = threading.Thread(target=self._watchdog, daemon=True)
        self._watch.start()

    # -- failure -------------------------------------------------------
    def log(self, r: int, tail: int = 3000) -> str:
        try:
            with open(os.path.join(self.dir, f"rank{r}.log")) as f:
                return f.read()[-tail:]
        except OSError:
            return ""

    def _exited(self, ok=(None,)):
        """The ranks that exited with a code not in ``ok``, each with the
        end of its output (one that fails takes its peers' connections
        with it: the watchdog may find several); None where none has."""
        codes = [(r, p.poll()) for r, p in enumerate(self.procs, 1)]
        return "\n".join(f"rank {r} exited with code {c}:\n{self.log(r)}"
                         for r, c in codes if c not in ok) or None

    def _watchdog(self):
        while not self._stop.wait(0.2):
            if self.closing:
                continue
            why = self._exited()
            if why:
                return self._fail(why)
            if self.deadline is not None and time.monotonic() > self.deadline:
                return self._fail(f"the ranks did not answer within "
                                  f"{self.timeout:.0f} s")

    def _fail(self, why: str):
        self.failure = f"portbench: run on {self.n} ranks failed: {why}"
        print(self.failure, file=sys.stderr, flush=True)
        self.kill()
        if self.backend == "nccl":
            os._exit(5)

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def check(self, exc=None):
        """Raise the watchdog's failure (from ``exc``) where there is one."""
        if self.failure:
            raise RuntimeError(self.failure) from exc

    # -- the run -------------------------------------------------------
    def join(self, job: dict):
        """Rank 0 joins the process group (the package's) and the side
        group, and hands every rank ``job``."""
        dist = _dist()
        timeout = datetime.timedelta(seconds=self.timeout)
        dist.init_process_group(
            self.backend, init_method=f"tcp://127.0.0.1:{self.port}",
            world_size=self.n, rank=0, timeout=timeout)
        self.side = dist.new_group(backend="gloo", timeout=timeout)
        dist.broadcast_object_list([job], src=0, group=self.side)
        self.deadline = None

    def scatter(self, volumes) -> list:
        """Send rank r its X slab of every volume; rank 0's own slabs."""
        import torch

        dist = _dist()
        mine = []
        for vol in volumes:
            step = vol.shape[0] // self.n
            self.deadline = time.monotonic() + self.timeout
            for r in range(1, self.n):
                dist.send(torch.from_numpy(np.ascontiguousarray(
                    vol[r * step:(r + 1) * step])), dst=r, group=self.side)
            mine.append(np.ascontiguousarray(vol[:step]))
        self.deadline = None
        return mine

    def tell(self, op: int, arg: int = 0):
        """Every rank's next step; the ranks have ``TIMEOUT_S`` seconds
        for it (until the next ``done``)."""
        import torch

        self.deadline = time.monotonic() + self.timeout
        _dist().broadcast(torch.tensor([op, arg], dtype=torch.int64), src=0,
                          group=self.side)

    def done(self):
        self.deadline = None

    def gather(self, op: int) -> list:
        """``tell(op)``, then what every other rank reports for it."""
        self.tell(op)
        out = [None] * self.n
        _dist().gather_object(None, out, dst=0, group=self.side)
        self.done()
        return out[1:]

    def close(self) -> list:
        """Stop the ranks, wait for them to exit, leave the groups; each
        other rank's report (the modules of ``FORBIDDEN`` it loaded, and
        its log)."""
        reports = self.gather(STOP)
        self.closing = True
        self.deadline = None
        _dist().destroy_process_group()
        for p in self.procs:
            try:
                p.wait(timeout=self.timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self._stop.set()
        for r, rep in enumerate(reports, 1):
            rep["log"] = self.log(r)
        shutil.rmtree(self.dir, ignore_errors=True)
        return reports

    def abandon(self):
        """On any failure: no rank left running, no directory left.  A
        rank that ended first (a peer sees its connection close before
        the watchdog looks) is named as the cause."""
        self.closing = True
        self._stop.set()
        until = time.monotonic() + 2.0
        while self.failure is None and time.monotonic() < until:
            why = self._exited(ok=(None, 0))
            if why:
                self._fail(why)
            else:
                time.sleep(0.05)
        self.kill()
        dist = _dist()
        if dist.is_initialized():
            try:
                dist.destroy_process_group()
            except Exception:  # noqa: BLE001 - the group may be broken
                pass
        shutil.rmtree(self.dir, ignore_errors=True)


def _orphan_guard():
    """Exit when the process that started this rank is gone."""
    parent = os.getppid()

    def watch():
        while True:
            time.sleep(1.0)
            if os.getppid() != parent:
                os._exit(3)
    threading.Thread(target=watch, daemon=True).start()


def rank_main(backend: str) -> int:
    """One rank other than 0: join, take the job and the slabs, follow
    rank 0's steps, report, exit."""
    _orphan_guard()
    import contextlib

    import torch
    import torch.distributed as dist
    from torch.profiler import record_function

    from portbench import devtrace, harness, spec
    from portbench import traffic as traffic_mod

    rank, local = int(os.environ["RANK"]), int(os.environ["LOCAL_RANK"])
    try:
        timeout = datetime.timedelta(seconds=2 * TIMEOUT_S)
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
        side = dist.new_group(backend="gloo", timeout=timeout)
        box = [None]
        dist.broadcast_object_list(box, src=0, group=side)
        job = box[0]
        device = (torch.device("cuda", local) if job["device"] == "cuda"
                  else torch.device("cpu"))
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:  # ranks that share the host's cores: one each
            torch.set_num_threads(1)
        cell = spec.Cell(**job["cell"])
        seed = job["seed"]
        port = resolve_port(job["port"])
        traffic = traffic_mod.make(cell.traffic, seed)
        kind = importlib.import_module(f"portbench.kinds.{traffic.kind}")
        n = traffic.n
        step = n // dist.get_world_size()
        slabs = []
        for _ in traffic.porosities:
            buf = torch.empty((step, n, n), dtype=torch.uint8)
            dist.recv(buf, src=0, group=side)
            slabs.append(buf.numpy())
        warm = traffic.warmup(seed)
        cmd = torch.zeros(2, dtype=torch.int64)
        with contextlib.ExitStack() as stack:
            traced, reduced = False, None
            while True:
                dist.broadcast(cmd, src=0, group=side)
                op, arg = (int(v) for v in cmd)
                if op == CALL:
                    req = (traffic.request(arg, seed) if arg >= 0
                           else warm[-1 - arg])
                    with (record_function(devtrace.ANSWER) if traced
                          else contextlib.nullcontext()):
                        kind.call(port, slabs[req.volume], req, cell.config,
                                  device, original_shape=(n, n, n))
                        if device.type == "cuda":
                            torch.cuda.synchronize()
                elif op == WARMED and device.type == "cuda":
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                elif op == CLOSED:
                    peak = (torch.cuda.max_memory_allocated()
                            if device.type == "cuda" else 0)
                    dist.gather_object({"peak_bytes": peak}, None, dst=0,
                                       group=side)
                elif op == TRACE_ON:
                    reduced = stack.enter_context(devtrace.traced())
                    traced = True
                    dist.gather_object(True, None, dst=0, group=side)
                elif op == TRACE_OFF:
                    stack.close()
                    traced = False
                    dist.gather_object(dict(reduced), None, dst=0,
                                       group=side)
                elif op == STOP:
                    break
        dist.gather_object({"forbidden": harness.forbidden_modules()}, None,
                           dst=0, group=side)
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - any failure ends the run
        print(f"portbench rank {rank}:", file=sys.stderr)
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    sys.stdout.flush()
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1]))
