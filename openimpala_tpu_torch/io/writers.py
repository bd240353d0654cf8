"""Result writers + reader dispatch (the port's own copy of
``openimpala_tpu/io/writers.py``; h5py is imported only by the HDF5 writer).

* ``write_results_txt`` — the flow-through summary file
  (``Diffusion.cpp:708-732``; format documented in reference
  ``README.md:261-276``).
* ``write_volume_hdf5_xdmf`` — field snapshots as HDF5 + XDMF, replacing
  AMReX plotfiles (``TortuosityHypre.cpp:710-749``,
  ``EffectiveDiffusivityHypre.cpp:648-680``) with a format ParaView/VisIt
  read natively.
* ``read_any`` — extension dispatch like the reference executable
  (``Diffusion.cpp:262-299``): .tif/.tiff -> TiffReader, .dat -> DatReader,
  .h5/.hdf5 -> HDF5Reader, .raw -> RawReader (dims+dtype required).
"""

from __future__ import annotations

import os

import numpy as np


def write_results_txt(path, filename, phase_id, volume_fraction, tortuosities: dict):
    """``results.txt`` with VolumeFraction + Tortuosity_{X,Y,Z} lines
    (9-decimal fixed format, ``Diffusion.cpp:719-726``)."""
    with open(path, "w") as f:
        f.write("# Tortuosity Calculation Results (Flow-Through Method)\n")
        f.write(f"# Input File: {filename}\n")
        f.write(f"# Analysis Phase ID: {phase_id}\n")
        f.write("# -----------------------------\n")
        f.write(f"VolumeFraction: {volume_fraction:.9f}\n")
        for name in sorted(tortuosities):
            f.write(f"{name}: {tortuosities[name]:.9f}\n")


def write_volume_hdf5_xdmf(basepath, fields: dict, dx=(1.0, 1.0, 1.0)):
    """Write named (X, Y, Z) fields to ``basepath.h5`` + ``basepath.xmf``.

    Data is stored C-order (Z, Y, X) in the HDF5 file (the convention our
    HDF5Reader and the reference's expect) and described by an XDMF file so
    ParaView/VisIt can open it directly.
    """
    import h5py

    h5path = basepath + ".h5"
    xmfpath = basepath + ".xmf"
    shapes = {np.asarray(v).shape for v in fields.values()}
    if len(shapes) != 1:
        raise ValueError("all fields must share one shape")
    (X, Y, Z) = shapes.pop()

    with h5py.File(h5path, "w") as f:
        for name, arr in fields.items():
            f.create_dataset(name, data=np.asarray(arr).transpose(2, 1, 0))

    h5name = os.path.basename(h5path)
    attrs = "\n".join(
        f"""      <Attribute Name="{name}" AttributeType="Scalar" Center="Cell">
        <DataItem Dimensions="{Z} {Y} {X}" NumberType="Float" Precision="8" Format="HDF">{h5name}:/{name}</DataItem>
      </Attribute>"""
        for name in fields
    )
    xmf = f"""<?xml version="1.0" ?>
<!DOCTYPE Xdmf SYSTEM "Xdmf.dtd" []>
<Xdmf Version="3.0">
  <Domain>
    <Grid Name="volume" GridType="Uniform">
      <Topology TopologyType="3DCoRectMesh" Dimensions="{Z + 1} {Y + 1} {X + 1}"/>
      <Geometry GeometryType="ORIGIN_DXDYDZ">
        <DataItem Dimensions="3" Format="XML">0 0 0</DataItem>
        <DataItem Dimensions="3" Format="XML">{dx[2]} {dx[1]} {dx[0]}</DataItem>
      </Geometry>
{attrs}
    </Grid>
  </Domain>
</Xdmf>
"""
    with open(xmfpath, "w") as f:
        f.write(xmf)
    return h5path, xmfpath


def read_any(path: str, hdf5_dataset: str = "image", raw_dims=None, raw_dtype=None):
    """Reader dispatch by extension (``Diffusion.cpp:262-299``)."""
    from .dat import DatReader
    from .hdf5 import HDF5Reader
    from .raw import RawReader
    from .tiff import TiffReader

    ext = os.path.splitext(path)[1].lower()
    if ext in (".tif", ".tiff"):
        return TiffReader(path)
    if ext in (".h5", ".hdf5"):
        return HDF5Reader(path, hdf5_dataset)
    if ext == ".dat":
        return DatReader(path)
    if ext == ".raw":
        if raw_dims is None or raw_dtype is None:
            raise ValueError("RAW files need raw_dims=(W,H,D) and raw_dtype")
        return RawReader(path, *raw_dims, raw_dtype)
    raise ValueError(f"unsupported file extension: {ext}")
