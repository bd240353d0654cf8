"""Run one function on several ranks of this machine, each in its own
process, joined into one ``torch.distributed`` group: the harness of the
sharded tests and of ``chip_smoke.py``'s ``sharded`` phase.

    results = spawn.run("package.module:function", 4, args=(...,),
                        backend="gloo", device="cpu", timeout=120)

(``device`` None, the default, means CUDA, as everywhere in the port:
the ranks then raise where there is no card.)

(``World(...)`` starts the same ranks and returns at once; its ``wait()``
returns the results.)

Every rank calls ``function(mesh, *args)`` with its ``parallel.mesh.Mesh``
and returns a picklable value; ``run`` returns them in rank order.  The
children are started as ``python -m openimpala_tpu_torch.parallel.spawn``
and import only the module of ``function`` (never the caller's module,
so a test file and what it imports stay out of them).  The group meets in
a ``file://`` store in a fresh directory, so worlds that run at the same
time never share a port.  A rank that raises fails the run with its
traceback; a world that has not ended within ``timeout`` seconds is
killed, every rank, and the run raises ``TimeoutError``.
"""

from __future__ import annotations

import importlib
import os
import pickle
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent.parent  # the checkout


def run(target: str, world_size: int, args=(), *, backend: str = "gloo",
        device=None, timeout: float = 120.0, workdir=None,
        threads: int | None = None) -> list:
    """``target(mesh, *args)`` on ``world_size`` ranks; their results in
    rank order.  ``device``: each rank's device (None or ``"cuda"`` for
    ``cuda:rank % count``, ``"cuda:0"`` for every rank on one card,
    ``"cpu"`` when the caller asks for the CPU).
    ``threads``: torch's intra-op threads in each rank (None: torch's
    default).  Each rank's output goes to ``rank<r>.log`` in ``workdir``
    (a new temporary directory when None); ``run_logs`` reads them."""
    return World(target, world_size, args, backend=backend, device=device,
                 timeout=timeout, workdir=workdir, threads=threads).wait()


class World:
    """The ranks of one ``run``, started at construction; ``wait()``
    returns their results (so the caller can work meanwhile)."""

    def __init__(self, target: str, world_size: int, args=(), *,
                 backend: str = "gloo", device=None, timeout: float = 120.0,
                 workdir=None, threads: int | None = None):
        self.target, self.n = target, int(world_size)
        self.workdir = workdir = Path(workdir or tempfile.mkdtemp(
            prefix="spawn_"))
        workdir.mkdir(parents=True, exist_ok=True)
        store = workdir / "store"
        if store.exists():
            store.unlink()
        job = {"target": target, "args": tuple(args), "world": self.n,
               "backend": backend,
               "device": None if device is None else str(device),
               "init": f"file://{store}", "timeout": float(timeout),
               "threads": threads}
        job_path = workdir / "job.pkl"
        job_path.write_bytes(pickle.dumps(job))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        self.procs = []
        for r in range(self.n):
            for name in (f"rank{r}.out", f"rank{r}.err"):
                (workdir / name).unlink(missing_ok=True)
            with open(workdir / f"rank{r}.log", "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", __name__, str(job_path), str(r)],
                    stdout=log, stderr=subprocess.STDOUT, env=env))
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout

    def wait(self) -> list:
        """The ranks' results in rank order; raises as ``run`` does, and
        leaves no rank running."""
        try:
            while True:
                codes = [p.poll() for p in self.procs]
                failed = [r for r, c in enumerate(codes)
                          if c not in (None, 0)]
                if failed:
                    raise RuntimeError(_failure(self.workdir, failed[0],
                                                codes))
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > self.deadline:
                    raise TimeoutError(
                        f"{self.target} on {self.n} ranks did not end "
                        f"within {self.timeout:.0f} s (exit codes {codes});"
                        f" logs in {self.workdir}")
                time.sleep(0.05)
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
            for p in self.procs:
                p.wait()
        return [pickle.loads((self.workdir / f"rank{r}.out").read_bytes())
                for r in range(self.n)]


def run_logs(workdir) -> list:
    """Each rank's output (``rank<r>.log``) of a ``run`` in ``workdir``."""
    logs = sorted(Path(workdir).glob("rank*.log"),
                  key=lambda p: int(p.stem[4:]))
    return [p.read_text() for p in logs]


def _failure(workdir: Path, rank: int, codes) -> str:
    err = workdir / f"rank{rank}.err"
    tb = err.read_text() if err.exists() else "(no traceback)"
    log = (workdir / f"rank{rank}.log").read_text()[-4000:]
    return (f"rank {rank} failed (exit codes {codes}):\n{tb}\n"
            f"--- its output ---\n{log}")


def _child(job_path: str, rank: int) -> int:
    import torch.distributed as dist

    from . import multihost
    from .mesh import make_mesh

    workdir = Path(job_path).parent
    job = pickle.loads(Path(job_path).read_bytes())
    try:
        if job["threads"]:
            import torch

            torch.set_num_threads(int(job["threads"]))
        multihost.initialize(job["backend"], job["init"], job["world"], rank,
                             timeout_s=job["timeout"])
        mesh = make_mesh(device=job["device"])
        module, name = job["target"].split(":")
        fn = getattr(importlib.import_module(module), name)
        out = fn(mesh, *job["args"])
        tmp = workdir / f"rank{rank}.out.tmp"
        tmp.write_bytes(pickle.dumps(out))
        os.replace(tmp, workdir / f"rank{rank}.out")
        dist.barrier()
        return 0
    except BaseException:
        (workdir / f"rank{rank}.err").write_text(traceback.format_exc())
        return 1
    finally:
        sys.stdout.flush()
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(_child(sys.argv[1], int(sys.argv[2])))
