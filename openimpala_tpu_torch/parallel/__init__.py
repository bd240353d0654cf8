"""The X-slab domain decomposition (counterpart of
``openimpala_tpu/parallel/``): ``mesh`` (the process group and this rank's
slab), ``halo`` (ghost planes), ``multihost`` (start-up) and ``spawn``
(several ranks on one machine, for tests and checks)."""

from . import multihost
from .halo import (
    halo_exchange_x,
    pad_halo,
    slab_stencil_apply,
)
from .mesh import (
    AXIS,
    Mesh,
    make_mesh,
    resolve_mesh,
    shard_volume,
    slab_range,
)

__all__ = [
    "multihost",
    "make_mesh",
    "shard_volume",
    "halo_exchange_x",
    "pad_halo",
    "slab_stencil_apply",
    "AXIS",
    "Mesh",
    "resolve_mesh",
    "slab_range",
]
