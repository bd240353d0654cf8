"""Host-side readers, writers and the native binding (counterpart of
``openimpala_tpu/io/``; the port keeps its own copies, numpy only but for
``TiffReader.threshold_tensor``, which thresholds on a PyTorch device).

Every reader shares the reference contract (``TiffReader.H:102-180``):
construction reads metadata only; ``threshold(thr, vtrue, vfalse)``
materialises the segmented (X, Y, Z) volume with strict ``value > thr``.
TIFF (uncompressed, through the numpy IFD codec), RAW and DAT need nothing
beyond numpy; compressed TIFFs need PIL and HDF5 needs h5py, each imported
only where it is used.
"""

from .cathode import (
    CathodeParams,
    write_dandeliion_parameters,
    write_pybamm_parameters,
)
from .dat import DatReader
from .hdf5 import HDF5Reader
from .ingest import PAD_FILL, threshold_sharded
from .raw import RawDataType, RawReader
from .tiff import TiffReader
from .writers import (
    read_any,
    write_results_txt,
    write_volume_hdf5_xdmf,
)

__all__ = [
    "threshold_sharded",
    "PAD_FILL",
    "TiffReader",
    "HDF5Reader",
    "DatReader",
    "RawReader",
    "RawDataType",
    "write_results_txt",
    "write_volume_hdf5_xdmf",
    "read_any",
    "CathodeParams",
    "write_dandeliion_parameters",
    "write_pybamm_parameters",
]
