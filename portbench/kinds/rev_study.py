"""A REV study: ``rev_study(volume, phase_id, sizes=..., num_samples=...,
rng=...)``, the D_eff tensor of each random crop, the crops drawn from the
request's own seed.  Compared: every crop's box against the reference's
draw from the same seed (exact), and ``check["crops"]`` of the crops'
tensors, drawn evenly over the sizes, against the reference solved far
below ``eps``."""

from __future__ import annotations

import functools

import numpy as np

from ..reference import props
from . import effective_diffusivity as whole
from . import stratified


def _rng(request):
    return np.random.default_rng(request.seed)


def call(port, volume, request, config, device, timings=None):
    return port.rev_study(
        volume, config["phase_id"], sizes=tuple(request.call["sizes"]),
        num_samples=request.call["num_samples"], eps=config["eps"],
        precond=config["precond"], rng=_rng(request), batch=config["batch"],
        dx=tuple(config["dx"]), device=device)


def results(answer) -> int:
    return len(answer)


def _boxes(volume, request):
    return props.rev_boxes(volume.shape, request.call["sizes"],
                           request.call["num_samples"], _rng(request))


def expected(request, traffic) -> int:
    return len(props.rev_boxes((traffic.n,) * 3, request.call["sizes"],
                               request.call["num_samples"], _rng(request)))


def failed(request, answer, traffic) -> int:
    bad = sum(0 if s.converged and np.all(np.isfinite(s.deff)) else 1
              for s in answer)
    return bad + max(0, expected(request, traffic) - len(answer))


def compare(answered, volumes, config, traffic, rng, device, dtype):
    worst = {"boxes": 0.0, "deff": 0.0}
    crops = []
    for r, a in answered:
        boxes = _boxes(volumes[r.volume], r)
        got = [(s.sample_no, s.size_target, tuple(s.seed),
                tuple(s.actual_size)) for s in a]
        worst["boxes"] = max(worst["boxes"], float(
            sum(1 for g, b in zip(got, boxes) if g != b)
            + abs(len(got) - len(boxes))))
        crops += [(r, s) for s in a]
    for r, s in stratified(crops, lambda c: c[1].size_target,
                           traffic.check["crops"], rng):
        lo, ext = s.seed, s.actual_size
        crop = volumes[r.volume][lo[0]:lo[0] + ext[0], lo[1]:lo[1] + ext[1],
                                 lo[2]:lo[2] + ext[2]]
        ref, _ = whole.reference(np.ascontiguousarray(crop), config, device,
                                 dtype)
        worst["deff"] = max(worst["deff"], whole.tensor_gap(s.deff, ref))
    return worst


class _LazyCrop:
    """A crop of the control's answer whose tensor is worked out when the
    comparison reads it (it reads a sample)."""

    def __init__(self, crop, config, device, dtype, **fields):
        self.__dict__.update(fields, converged=True)
        self._args = (crop, config, device, dtype)

    @functools.cached_property
    def deff(self):
        return whole.reference(*self._args)[0]


def control_answer(volume, request, config, device, dtype):
    return [_LazyCrop(np.ascontiguousarray(
        volume[lo[0]:lo[0] + ext[0], lo[1]:lo[1] + ext[1],
               lo[2]:lo[2] + ext[2]]), config, device, dtype,
        sample_no=s_no, size_target=size, seed=lo, actual_size=ext)
        for s_no, size, lo, ext in _boxes(volume, request)]

