"""Physics drivers: volume fraction, flow-through tortuosity, homogenised
effective diffusivity, REV studies, and the explicit baseline solver.

The drivers whose function shares its module's name are reached from the
package root (``openimpala_tpu_torch.tortuosity``, ``.effective_diffusivity``,
``.volume_fraction``), so that ``props.<module>`` stays the module;
``tortuosity_direct`` is exported here as the JAX package exports it,
and so are ``parse_direction`` and ``DIRECTIONS``.
"""

from ..utils.common import DIRECTIONS, parse_direction  # noqa: F401

from .effective_diffusivity import (
    EffectiveDiffusivityResult,
    deff_tensor,
    prime_cell_solver,
)
from .rev import rev_study
from .tortuosity import TortuosityResult, prime_solver
from .tortuosity_direct import (
    TortuosityDirectResult,
    tortuosity_direct,
)
from .volume_fraction import volume_fraction_counts

__all__ = [
    "volume_fraction_counts",
    "TortuosityResult",
    "prime_solver",
    "deff_tensor",
    "EffectiveDiffusivityResult",
    "prime_cell_solver",
    "tortuosity_direct",
    "TortuosityDirectResult",
    "rev_study",
]
