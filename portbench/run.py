#!/usr/bin/env python3
"""Run one cell of the benchmark of ``openimpala_tpu_torch`` once, from
the root of a checkout:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

One process on one CUDA device, or for a cell of several cards one rank
per card (``portbench/ranks.py``; this process is rank 0): set-up (the
package's kernels loaded or built into its own build directory, the
volumes made on the device from the seed, one request of the cell's shape
per direction), a closed-loop window of ``--seconds``, with ``--trace 1``
a profiled sub-window, the comparison with the plain reference, and one
JSON line on standard output.  Without as many CUDA devices as the cell
asks for it prints no result and exits with 3.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# import from the checkout's root, not from this folder
sys.path = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != HERE]
# every kernel cache at a fixed path inside the checkout
_CACHE = os.path.join(ROOT, ".portbench_cache")
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = os.path.join(_CACHE, _sub)

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(T0))
