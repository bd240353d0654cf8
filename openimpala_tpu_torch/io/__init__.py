"""Host-side readers, writers and the native binding (counterpart of
``openimpala_tpu/io/``; the port keeps its own copies, numpy only).

Every reader shares the reference contract (``TiffReader.H:102-180``):
construction reads metadata only; ``threshold(thr, vtrue, vfalse)``
materialises the segmented (X, Y, Z) volume with strict ``value > thr``.
TIFF (uncompressed, through the numpy IFD codec), RAW and DAT need nothing
beyond numpy; compressed TIFFs need PIL and HDF5 needs h5py, each imported
only where it is used.
"""

from .cathode import (  # noqa: F401
    CathodeParams,
    write_dandeliion_parameters,
    write_pybamm_parameters,
)
from .dat import DatReader  # noqa: F401
from .hdf5 import HDF5Reader  # noqa: F401
from .ingest import PAD_FILL, threshold_sharded  # noqa: F401
from .raw import RawDataType, RawReader  # noqa: F401
from .tiff import TiffReader  # noqa: F401
from .writers import (  # noqa: F401
    read_any,
    write_results_txt,
    write_volume_hdf5_xdmf,
)
