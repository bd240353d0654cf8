"""Request kinds, one module each, found by the ``kind`` of a traffic file.

A kind module has:

* ``call(port, volume, request, config, device, timings)``: one request
  to the measured package (``port``), with the host volume; returns the
  answer as the entry point returns it (a kind that a cell on several
  cards runs also takes ``original_shape``: the volume is then this
  rank's X slab);
* ``results(answer)``: how many results (tau values, tensors) it holds;
* ``expected(request, traffic)``: how many it should hold;
* ``failed(request, answer, traffic)``: how many of them did not come
  or are not finite and converged;
* ``compare(answered, volumes, config, traffic, rng, device, dtype)``:
  the reference's readings of a sample of ``answered`` (a list of
  ``(request, answer)``) drawn with ``rng``: ``{name: worst value}``;
* ``control_answer(volume, request, config, device, dtype)``: the
  reference in ``dtype`` shaped as the package's answer, worked out only
  where the comparison reads it.
"""

from __future__ import annotations


def stratified(items, key, n, rng):
    """``n`` of ``items`` drawn with ``rng`` and spread evenly over the
    groups that ``key`` makes (a remainder goes to groups drawn too)."""
    groups = {}
    for it in items:
        groups.setdefault(key(it), []).append(it)
    names = sorted(groups)
    extra = set(rng.permutation(len(names))[:n % len(names)].tolist())
    out = []
    for g, name in enumerate(names):
        members = groups[name]
        want = min(len(members), n // len(names) + (g in extra))
        out += [members[j] for j in sorted(rng.choice(len(members), want,
                                                      replace=False))]
    return out


class Lazy:
    """An answer whose fields ``make()`` works out on their first read:
    the control answers every request, the comparison reads a sample."""

    def __init__(self, make):
        self._make = make

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        if "_fields" not in self.__dict__:
            self._fields = self._make()
        return getattr(self._fields, name)
