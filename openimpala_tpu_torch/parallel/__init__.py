"""The X-slab domain decomposition (counterpart of
``openimpala_tpu/parallel/``): ``mesh`` (the process group and this rank's
slab), ``halo`` (ghost planes), ``multihost`` (start-up) and ``spawn``
(several ranks on one machine, for tests and checks)."""

from . import multihost  # noqa: F401
from .halo import (  # noqa: F401
    halo_exchange_x,
    pad_halo,
    slab_stencil_apply,
)
from .mesh import (  # noqa: F401
    AXIS,
    Mesh,
    make_mesh,
    resolve_mesh,
    shard_volume,
    slab_range,
)
