"""The package as every rank of a run on several ranks builds it for a
test: ``harness.run_cell(..., port="portbench.tests.slab_ports:<name>")``
has each rank call ``<name>()`` (``ranks.resolve_port``), since a patch
made in the test's own process does not reach the other ranks.  Faults
planted under the package, and a recorder of rank 0's answers."""

import dataclasses
import os
import signal
import types

import torch


ANSWERS = []  # (request's direction, answer) of every recorded call


def _port():
    import openimpala_tpu_torch as port
    return port


def recorded():
    """The package, with each answer kept in ``ANSWERS``."""
    real = _port().tortuosity

    def keep(volume, phase_id, direction, *a, **k):
        out = real(volume, phase_id, direction, *a, **k)
        ANSWERS.append((direction, out))
        return out
    return types.SimpleNamespace(tortuosity=keep)


def state():
    """Every solve returns the state it started from and says it
    converged."""
    from openimpala_tpu_torch.props import tortuosity as pt

    def unchanged(system, x0, **kw):
        return system.assemble_solution(x0), types.SimpleNamespace(
            iterations=0, rel_res=0.0, converged=True)
    pt.solve_system = unchanged
    return _port()


def answer():
    """tau altered by 1e-5 where the entry point produces it."""
    real = _port().tortuosity

    def altered(*a, **k):
        out = real(*a, **k)
        return dataclasses.replace(out, value=out.value * (1 + 1e-5))
    return types.SimpleNamespace(tortuosity=altered)


def exchange():
    """The halo exchange between the ranks left out: every ghost plane
    zero, as at the ends of a clamped axis."""
    from openimpala_tpu_torch.parallel import mesh

    def none(self, first, last, periodic):
        return torch.zeros_like(first), torch.zeros_like(last)
    mesh.Mesh.exchange = none
    return _port()


def killed():
    """Rank 2 is killed at its fifth call: with three directions, the
    window's second request."""
    real = _port().tortuosity
    calls = [0]

    def dies(*a, **k):
        calls[0] += 1
        if os.environ.get("RANK") == "2" and calls[0] == 5:
            os.kill(os.getpid(), signal.SIGKILL)
        return real(*a, **k)
    return types.SimpleNamespace(tortuosity=dies)
