#!/usr/bin/env python3
"""The control of a cell's comparison: the plain reference put in the
package's place, in the precision below the one the configuration states
(float32 for float64), judged by the same comparison as a run.  It has to
come out as not correct; its readings are the upper ends between which a
cell's limits are set.

    python3 portbench/control.py --workload <name> --seeds <n> [<n> ...]

The answers compared are drawn from one cycle of each seed's stream (every
volume along every direction) as a run draws them; the control works out
only those.  One JSON line per
seed, then one with the smallest readings.  Not part of a benchmark run.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != HERE]

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402

import numpy as np  # noqa: E402

from portbench import blobs, ranks, spec  # noqa: E402
from portbench import traffic as traffic_mod  # noqa: E402


def readings(cell, seed, device, dtype="float32"):
    """The comparison's readings of the control for one seed (a cell on
    several cards: the reference on X slabs over as many devices)."""
    import torch

    ref_device = ranks.devices(device, cell.chips)
    tr = traffic_mod.make(cell.traffic, seed)
    kind = importlib.import_module(f"portbench.kinds.{tr.kind}")
    k = len(tr.porosities) * max(1, len(tr.directions))
    volumes = [blobs.blobs(tr.n, p, s, device).cpu().numpy()
               for p, s in zip(tr.porosities, tr.volume_seeds)]
    # worked out only where the comparison reads them
    answered = [(r, kind.control_answer(volumes[r.volume], r, cell.config,
                                        ref_device, getattr(torch, dtype)))
                for r in (tr.request(i, seed) for i in range(k))]
    rng = np.random.default_rng(blobs.seed_of(seed, traffic_mod.CHECK))
    got = kind.compare(answered, volumes, cell.config, tr, rng, ref_device,
                       torch.float64)
    limits = tr.check["limits"]
    return {"seed": seed, "readings": got,
            "correct": all(v <= limits[n] for n, v in got.items())}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = spec.cell(spec.load(), args.workload)
    rows = []
    for seed in args.seeds:
        rows.append(readings(cell, seed, "cuda"))
        print(json.dumps(rows[-1]), flush=True)
    upper = {n: min(r["readings"][n] for r in rows)
             for n in rows[0]["readings"]}
    print(json.dumps({"workload": args.workload, "dtype": "float32",
                      "least_reading": upper,
                      "all_incorrect": not any(r["correct"] for r in rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
