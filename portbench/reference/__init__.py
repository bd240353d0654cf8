"""The benchmark's plain reference: PyTorch and NumPy only.

It restates the upstream OpenImpala discretisation (the flow-through fill
of ``TortuosityHypreFill.F90``, the periodic cell problem of
``EffDiffFillMtx.F90``, the flux integral of ``TortuosityHypre.cpp`` and
the tensor integral of ``Diffusion.cpp``) in its own words and imports
nothing of the measured package nor of the JAX package.  It runs on
whatever device its inputs are on, in the dtype it is given.
"""
