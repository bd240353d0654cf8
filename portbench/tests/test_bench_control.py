"""The comparison that decides ``correct`` fails what it must: the control
(the reference in float32 put in the package's place) and a run whose
timed path is broken underneath, on the CPU at small sizes, with the
cells' own limits.  ``portbench/control.py`` reads the control at the
cells' own sizes on the card."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from portbench import control, harness

from conftest import small_cell

# (cell, edge, volumes, porosity, traffic overrides)
SMALL = {
    "tau512.xyz": (48, 2, 0.4, {}),
    "tau128.screen": (32, 6, None, {}),
    "deff512.tensor": (40, 2, 0.4, {}),
    # the three cell problems as lockstep lanes
    "deff100.sample": (36, 6, None, {}),
    "rev512.batched": (64, 1, 0.4, {"call": {"sizes": [16, 24],
                                            "num_samples": 3}}),
    # four gloo ranks on the CPU, slabs of 12 planes
    "tau1024.slabs4": (48, 2, 0.4, {}),
    # each request a run of the CLI (device = cpu) on a TIFF stack
    "cli512.xyz": (32, 2, None, {}),
}
SEED = 2 ** 32 + 11


def _cell(name):
    n, v, p, extra = SMALL[name]
    return small_cell(name, n, volumes=v, porosity=p, **extra)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_is_not_correct(name):
    out = control.readings(_cell(name), SEED, "cpu", "float32")
    assert not out["correct"], out


@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_sound_run_is_correct(name):
    out = harness.run_cell(_cell(name), SEED, 0.1, False, "cpu", 0.0)
    assert out["correct"], out["checks"]


def _unchanged_state(system, x0, **kw):
    """A solve whose steps leave the state as it was, and say converged."""
    return system.assemble_solution(x0), types.SimpleNamespace(
        iterations=0, rel_res=0.0, converged=True)


def _altered(real, scale):
    def wrapped(*a, **k):
        out = real(*a, **k)
        if hasattr(out, "value"):
            return dataclasses.replace(out, value=out.value * scale)
        return dataclasses.replace(out, deff=out.deff * scale)
    return wrapped


def _unchanged_lanes(lsys, **kw):
    """A lockstep solve whose steps leave every lane's state as it was,
    and say converged."""
    x0 = torch.zeros_like(lsys.r0_b, dtype=kw["outer_dtype"])
    return lsys.assemble_solution(x0), types.SimpleNamespace(
        iterations=(0,) * lsys.lanes, rel_res=(0.0,) * lsys.lanes,
        converged=(True,) * lsys.lanes)


def _half_batch(real):
    """Half of each batch of crops solved; the rest given the mean of
    those."""
    def wrapped(crops, *a, **k):
        half = max(1, len(crops) // 2)
        deffs, convs = real(crops[:half], *a, **k)
        mean = np.mean(np.stack(deffs), axis=0)
        return (list(deffs) + [mean] * (len(crops) - half),
                list(convs) + [True] * (len(crops) - half))
    return wrapped


FAULTS = [
    ("tau512.xyz", "state"), ("tau512.xyz", "answer"),
    ("tau128.screen", "state"), ("tau128.screen", "answer"),
    ("deff512.tensor", "state"), ("deff512.tensor", "answer"),
    ("deff100.sample", "state"), ("deff100.sample", "answer"),
    ("rev512.batched", "half_batch"), ("rev512.batched", "state"),
    ("tau1024.slabs4", "state"), ("tau1024.slabs4", "answer"),
    ("tau1024.slabs4", "exchange"),
]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    import openimpala_tpu_torch as port
    from openimpala_tpu_torch.props import effective_diffusivity as pe
    from openimpala_tpu_torch.props import tortuosity as pt
    from openimpala_tpu_torch.solve import batched

    from openimpala_tpu_torch.parallel import mesh

    cell = _cell(name)
    if cell.chips > 1:  # planted in every rank (slab_ports.py)
        # this process is rank 0: what the fault patches here is undone
        monkeypatch.setattr(pt, "solve_system", pt.solve_system)
        monkeypatch.setattr(mesh.Mesh, "exchange", mesh.Mesh.exchange)
        out = harness.run_cell(cell, SEED, 0.1, False, "cpu", 0.0,
                               port=f"portbench.tests.slab_ports:{fault}")
        assert not out["correct"], out["checks"]
        return
    cell.config = dict(cell.config)
    if name == "deff512.tensor":
        cell.config["lanes"] = False  # the sequential path, as at 512^3
    broken = types.SimpleNamespace(
        tortuosity=port.tortuosity,
        effective_diffusivity=port.effective_diffusivity,
        rev_study=port.rev_study)
    if fault == "state":
        monkeypatch.setattr(pt, "solve_system", _unchanged_state)
        monkeypatch.setattr(pe, "solve_system", _unchanged_state)
        monkeypatch.setattr(pe, "solve_system_lanes", _unchanged_lanes)
        real = batched._batched_cg

        def frozen(systems, r0, denom, eps, maxiter, precond, *a, **k):
            return real(systems, r0, denom, eps, 0, precond, *a, **k)
        monkeypatch.setattr(batched, "_batched_cg", frozen)
    elif fault == "answer":
        broken.tortuosity = _altered(port.tortuosity, 1 + 1e-5)
        broken.effective_diffusivity = _altered(
            port.effective_diffusivity, 1 + 1e-5)
    else:
        monkeypatch.setattr(batched, "batched_deff",
                            _half_batch(batched.batched_deff))
    out = harness.run_cell(cell, SEED, 0.1, False, "cpu", 0.0, port=broken)
    assert not out["correct"], out["checks"]
