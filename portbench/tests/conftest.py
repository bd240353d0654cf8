"""CPU tests of the benchmark's harness and reference (run from the
repository's root: ``python -m pytest portbench/tests -q``).  Tests that
need the card carry the ``cuda`` marker and skip without one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def small_cell(name, n, volumes=None, porosity=None, **traffic):
    """The cell ``name`` of BENCHMARK.json cut to a CPU-sized volume."""
    from portbench import spec

    cell = spec.cell(spec.load(), name)
    cell.traffic["n"] = n
    if volumes is not None:
        cell.traffic["volumes"] = volumes
    if porosity is not None:
        cell.traffic["porosity"] = porosity
    cell.traffic.update(traffic)
    return cell
