"""The D_eff tensor of a whole volume: ``effective_diffusivity(volume,
phase_id, eps=...)``, the three periodic cell problems.  Compared: the
phase's cells counted (exact) and the tensor against the reference solved
far below ``eps``, as the largest entry's gap over the largest entry."""

from __future__ import annotations

import math
import sys
import time
import types

import numpy as np
import torch

from ..reference import props, slab_cells, slabs
from . import Lazy


def call(port, volume, request, config, device, timings=None,
         original_shape=None):
    """``original_shape``: ``volume`` is this rank's X slab of a volume of
    that shape (every rank of the process group calls)."""
    extra = {} if original_shape is None else {
        "original_shape": original_shape}
    return port.effective_diffusivity(
        volume, config["phase_id"], eps=config["eps"],
        precond=config["precond"], lanes=config["lanes"],
        dx=tuple(config["dx"]), device=device, timings=timings, **extra)


def results(answer) -> int:
    return 1


def expected(request, traffic) -> int:
    return 1


def failed(request, answer, traffic) -> int:
    ok = answer.converged and bool(np.all(np.isfinite(answer.deff)))
    return 0 if ok else 1


def tensor_gap(got, ref) -> float:
    got = np.asarray(got, dtype=np.float64)
    if not np.all(np.isfinite(got)):
        return math.inf
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def reference(volume, config, device, dtype):
    """(tensor, number of phase cells) of a host volume; ``device`` a
    tuple of devices: on X slabs over them (``reference/slab_cells.py``)."""
    t0 = time.perf_counter()
    if isinstance(device, tuple):
        ok = [s == config["phase_id"] for s in slabs.split(volume, device)]
        tensor, infos = slab_cells.deff_tensor(ok, tuple(config["dx"]),
                                               dtype)
        n_phase = sum(int(o.sum()) for o in ok)
    else:
        ok = torch.from_numpy(volume).to(device) == config["phase_id"]
        tensor, infos = props.deff_tensor(ok, tuple(config["dx"]), dtype)
        n_phase = int(ok.sum())
    if not all(i.converged for i in infos) and dtype == torch.float64:
        raise RuntimeError(f"the reference failed: {infos}")
    if volume.size >= 2 ** 21:  # whole volumes, not REV crops
        print(f"portbench: reference tensor {dtype}: "
              f"{time.perf_counter() - t0:.3f} s, steps "
              f"{[i.iterations for i in infos]}", file=sys.stderr, flush=True)
    return tensor, n_phase


def compare(answered, volumes, config, traffic, rng, device, dtype):
    keys = sorted({r.volume for r, _ in answered})
    take = rng.choice(len(keys), min(len(keys), traffic.check["answers"]),
                      replace=False)
    worst = {"vf_cells": 0.0, "deff": 0.0}
    for j in sorted(take):
        v = keys[j]
        ref, n_phase = reference(volumes[v], config, device, dtype)
        for r, a in answered:
            if r.volume != v:
                continue
            worst["vf_cells"] = max(worst["vf_cells"], float(abs(
                round(a.volume_fraction * volumes[v].size) - n_phase)))
            worst["deff"] = max(worst["deff"], tensor_gap(a.deff, ref))
    return worst


def control_answer(volume, request, config, device, dtype):
    def make():
        tensor, n_phase = reference(volume, config, device, dtype)
        return types.SimpleNamespace(deff=tensor, converged=True,
                                     volume_fraction=n_phase / volume.size)
    return Lazy(make)
