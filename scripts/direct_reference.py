#!/usr/bin/env python3
"""The JAX package's value of the explicit baseline solver on the volume
that ``chip_smoke.py``'s ``main[direct]`` drives, for the port to be held
against on the card:

    JAX_PLATFORMS=cpu python3 -m scripts.direct_reference [--n 48]

(from the repo root; needs JAX).  Runs ``openimpala_tpu.props.
tortuosity_direct(make_blobs(n, 0.6, 0), 1, "X", eps=1e-6)`` in float64 on
the CPU and prints one JSON line: the value, the steps, the residual, the
two boundary fluxes, the wall seconds and the JAX version.  On an x86 CPU
with JAX 0.9.0 at n = 48: value -2.7714819921465814 in 43531 steps,
residual 9.9128850616742e-07 (``chip_smoke.DIRECT_JAX``).
"""

from __future__ import annotations

import argparse
import importlib
import json
import time

from openimpala_tpu_torch.utils.sample_data import make_blobs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=48)
    args = ap.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    importlib.import_module("openimpala_tpu")  # enables float64
    jd = importlib.import_module("openimpala_tpu.props.tortuosity_direct")
    vol = make_blobs(args.n, 0.6, 0)
    t0 = time.perf_counter()
    r = jd.tortuosity_direct(vol, 1, "X", eps=1e-6)
    print(json.dumps({
        "n": args.n, "value": r.value, "iterations": r.iterations,
        "residual": r.residual, "flux_in": r.flux_in,
        "flux_out": r.flux_out, "converged": r.converged,
        "seconds": time.perf_counter() - t0, "jax": jax.__version__,
        "backend": jax.default_backend()}))


if __name__ == "__main__":
    main()
