"""The one traffic generator: a cell's file of parameters and a seed in,
the volumes and the request stream out.

A traffic file (``portbench/workloads/<traffic>.json``) holds:

* ``kind``: the request, a module of ``portbench/kinds/``;
* ``n``: the volumes' edge; ``volumes``: how many distinct volumes;
* ``porosity``: one number for all of them, or ``[lo, hi]``: then the
  volumes' porosities are ``lo + (hi - lo) (k + 1/2) / volumes``, the same
  set for every seed, handed out in an order drawn from the seed;
* ``directions``: the flow directions requests cycle through (none for a
  request that takes no direction);
* ``call``: further arguments of the request (such as a REV study's
  ``sizes`` and ``num_samples``);
* ``check``: how many answers the comparison with the reference draws,
  and each compared number's limit; ``trace``: how many answers the
  traced sub-window profiles.

Request ``i`` asks about volume ``i % volumes`` along
``directions[i % len(directions)]``: with coprime counts the stream walks
every (volume, direction) pair before it repeats one.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .blobs import seed_of

# streams of numbers drawn from one run seed
VOLUMES, ORDER, REQUESTS, CHECK, WARM = range(5)


@dataclasses.dataclass
class Request:
    index: int
    volume: int
    direction: str | None
    seed: int  # the request's own seed (a REV study draws its crops from it)
    call: dict  # the traffic file's further arguments of the request


@dataclasses.dataclass
class Traffic:
    kind: str
    n: int
    porosities: list
    volume_seeds: list
    directions: list
    call: dict
    check: dict
    trace: dict

    def request(self, i: int, seed: int) -> Request:
        d = self.directions[i % len(self.directions)] if self.directions \
            else None
        return Request(i, i % len(self.porosities), d,
                       seed_of(seed, REQUESTS, i), self.call)

    def warmup(self, seed: int) -> list:
        """One request of the cell's shape on volume 0 for each direction
        the stream uses, with a seed of its own."""
        dirs = self.directions or [None]
        return [Request(-1 - j, 0, d, seed_of(seed, WARM, j), self.call)
                for j, d in enumerate(dirs)]


def make(spec: dict, seed: int) -> Traffic:
    v = int(spec["volumes"])
    por = spec["porosity"]
    if isinstance(por, (int, float)):
        porosities = [float(por)] * v
    else:
        lo, hi = (float(p) for p in por)
        order = np.random.default_rng(seed_of(seed, ORDER)).permutation(v)
        porosities = [lo + (hi - lo) * (k + 0.5) / v for k in order]
    return Traffic(
        kind=spec["kind"], n=int(spec["n"]), porosities=porosities,
        volume_seeds=[seed_of(seed, VOLUMES, j) for j in range(v)],
        directions=list(spec.get("directions") or []),
        call=dict(spec.get("call") or {}), check=dict(spec["check"]),
        trace=dict(spec["trace"]))
