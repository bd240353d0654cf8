"""Flow-through tau along one direction: ``tortuosity(volume, phase_id,
direction, eps=...)``.  Compared: the active cells counted by the
percolation mask (exact), tau and both face fluxes against the reference
solved far below ``eps`` (relative gaps), and the flux conservation gate
the configuration states (its own limit, 1e-6), on ``check["answers"]``
(volume, direction) pairs drawn evenly over the directions."""

from __future__ import annotations

import math
import sys
import time
import types

import torch

from ..reference import props, slabs
from . import Lazy, stratified

AXES = {"X": 0, "Y": 1, "Z": 2}


def call(port, volume, request, config, device, timings=None,
         original_shape=None):
    """``original_shape``: ``volume`` is this rank's X slab of a volume of
    that shape (every rank of the process group calls)."""
    extra = {} if original_shape is None else {
        "original_shape": original_shape}
    return port.tortuosity(
        volume, config["phase_id"], request.direction, vlo=config["vlo"],
        vhi=config["vhi"], eps=config["eps"], precond=config["precond"],
        percolation_method=config["percolation_method"],
        dx=tuple(config["dx"]), device=device, timings=timings, **extra)


def results(answer) -> int:
    return 1


def expected(request, traffic) -> int:
    return 1


def failed(request, answer, traffic) -> int:
    ok = (answer.converged and answer.flux_conserved
          and math.isfinite(answer.value))
    return 0 if ok else 1


def _gap(a, b):
    return abs(a - b) / abs(b) if math.isfinite(a) else math.inf


def _tau_of(a, shape, axis, config):
    """The answer's tau; where its conservation gate withheld tau (NaN),
    the tau its own fluxes give (that gate's failure is read as
    ``flux_rel_diff``), so that every answer gives a number."""
    if math.isfinite(a.value) or not (
            math.isfinite(a.flux_in) and math.isfinite(a.flux_out)):
        return a.value
    dx = tuple(config["dx"])
    others = [b for b in range(3) if b != axis]
    area = shape[others[0]] * dx[others[0]] * shape[others[1]] * dx[
        others[1]]
    grad = (config["vhi"] - config["vlo"]) / (shape[axis] * dx[axis])
    mag = 0.5 * (abs(a.flux_in) + abs(a.flux_out))
    return a.active_vf * abs(grad) * area / mag if mag > 0 else math.inf


def reference(volume, direction, config, device, dtype):
    """The reference's answer for one (volume, direction), a dict;
    ``device`` a tuple of devices: on X slabs over them
    (``reference/slabs.py``)."""
    t0 = time.perf_counter()
    axis = AXES[direction]
    ref = slabs if isinstance(device, tuple) else props
    if ref is slabs:
        ok = [s == config["phase_id"] for s in slabs.split(volume, device)]
    else:
        ok = torch.from_numpy(volume).to(device) == config["phase_id"]
    active, n_active = ref.percolation(ok, axis)
    del ok
    t1 = time.perf_counter()  # the count above waited for the device
    out = ref.tortuosity(active, n_active, axis, config["vlo"],
                         config["vhi"], tuple(config["dx"]), dtype)
    out["n_active"] = n_active
    print(f"portbench: reference {direction} {dtype}: percolation "
          f"{t1 - t0:.3f} s, solve {time.perf_counter() - t1:.3f} s, "
          f"{out['iterations']} steps, rel_res {out['rel_res']:.2e}",
          file=sys.stderr, flush=True)
    return out


def compare(answered, volumes, config, traffic, rng, device, dtype):
    keys = sorted({(r.volume, r.direction) for r, _ in answered})
    take = stratified(keys, lambda k: k[1], traffic.check["answers"], rng)
    worst = {"vf_cells": 0.0, "tau": 0.0, "flux": 0.0, "flux_rel_diff": 0.0}
    for v, d in take:
        ref = reference(volumes[v], d, config, device, dtype)
        if not (ref["converged"] and math.isfinite(ref["tau"])):
            raise RuntimeError(f"the reference failed on volume {v} {d}: "
                               f"{ref}")
        total = volumes[v].size
        for r, a in answered:
            if (r.volume, r.direction) != (v, d):
                continue
            got = {
                "vf_cells": abs(round(a.active_vf * total) - ref["n_active"]),
                "tau": _gap(_tau_of(a, volumes[v].shape, AXES[d], config),
                            ref["tau"]),
                "flux": max(_gap(a.flux_in, ref["flux_in"]),
                            _gap(a.flux_out, ref["flux_out"])),
                "flux_rel_diff": (a.flux_rel_diff
                                  if math.isfinite(a.flux_rel_diff)
                                  else math.inf),
            }
            for k, x in got.items():
                worst[k] = max(worst[k], float(x))
    return worst


def control_answer(volume, request, config, device, dtype):
    """The reference in ``dtype``, shaped as the program's answer (the
    control put in the program's place)."""
    def make():
        ref = reference(volume, request.direction, config, device, dtype)
        return types.SimpleNamespace(
            value=ref["tau"], active_vf=ref["active_vf"],
            flux_in=ref["flux_in"], flux_out=ref["flux_out"],
            flux_rel_diff=ref["flux_rel_diff"],
            flux_conserved=ref["flux_conserved"],
            converged=ref["converged"])
    return Lazy(make)
