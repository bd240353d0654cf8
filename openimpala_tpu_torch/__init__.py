"""openimpala_tpu_torch — the PyTorch/CUDA port of ``openimpala_tpu``.

Same layout (``ops/``, ``solve/``, ``props/``, ``utils/``, ``parallel/``)
and function names as the JAX package, which stays the reference.  Plain
tensor code is PyTorch; the Pallas TPU kernels of the path are hand-written
CUDA kernels for Hopper (``csrc/``, built on first use by
``ops/stencil_cuda.py``).

Entry points take ``device=None``, meaning CUDA; without a card they raise
unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from . import ops, parallel, props, solve  # noqa: F401
from .props.effective_diffusivity import (  # noqa: F401
    EffectiveDiffusivityResult,
    deff_tensor,
    effective_diffusivity,
)
from .props.rev import rev_study  # noqa: F401
from .props.tortuosity import TortuosityResult, tortuosity  # noqa: F401
from .props.tortuosity_direct import (  # noqa: F401
    TortuosityDirectResult,
    tortuosity_direct,
)
from .props.volume_fraction import volume_fraction  # noqa: F401
