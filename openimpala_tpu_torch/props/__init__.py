"""Physics drivers: volume fraction, flow-through tortuosity, homogenised
effective diffusivity, REV studies, and the explicit baseline solver.

The drivers whose function shares its module's name are reached from the
package root (``openimpala_tpu_torch.tortuosity``, ``.effective_diffusivity``,
``.volume_fraction``), so that ``props.<module>`` stays the module;
``tortuosity_direct`` is exported here as the JAX package exports it.
"""

from .effective_diffusivity import (  # noqa: F401
    EffectiveDiffusivityResult,
    deff_tensor,
    prime_cell_solver,
)
from .rev import rev_study  # noqa: F401
from .tortuosity import TortuosityResult, prime_solver  # noqa: F401
from .tortuosity_direct import (  # noqa: F401
    TortuosityDirectResult,
    tortuosity_direct,
)
from .volume_fraction import volume_fraction_counts  # noqa: F401
