"""Stencil systems, masks, percolation, fluxes and the CUDA kernels.

Exports the names of ``openimpala_tpu/ops/__init__.py``.  Importing the
package builds and loads no kernel: ``stencil_cuda`` and ``offset_cuda``
build theirs on the first launch.
"""

from .filters import remspot
from .floodfill import flood_fill_device, flood_fill_host, percolation_mask
from .flux import boundary_fluxes, deff_integrand_sum
from .masks import linear_ramp, pad_volume_to, phase_mask
from .stencil import (
    StencilSystem,
    apply_restricted,
    check_operator_properties,
    make_cell_problem_system,
    make_tortuosity_system,
    neighbor_sum,
    weighted_degree,
)

__all__ = [
    "StencilSystem",
    "apply_restricted",
    "neighbor_sum",
    "weighted_degree",
    "make_tortuosity_system",
    "make_cell_problem_system",
    "check_operator_properties",
    "phase_mask",
    "pad_volume_to",
    "linear_ramp",
    "percolation_mask",
    "flood_fill_device",
    "flood_fill_host",
    "remspot",
    "boundary_fluxes",
    "deff_integrand_sum",
]
