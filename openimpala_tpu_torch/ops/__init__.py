"""Stencil systems, masks, percolation, fluxes and the CUDA kernels."""
