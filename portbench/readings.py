#!/usr/bin/env python3
"""The readings the limits are set from: the numbers ``correct`` compares,
for the program, the control or a planted fault, over many seeds of one
cell in one process (set-up paid once), at the cell's own size, on the card.

    python3 portbench/readings.py --workload <cell> --seeds 11,12,13 \
        --systems program,control --seconds 5

One JSON line a run on standard output: the system, the seed, the blocks,
``correct``, each number beside its limit, where the worst was, the seconds
the checks took.  See PERF.md (section 2) for the readings and the limits."""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path.insert(0, ROOT)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--systems", default="program", help="program, control, fault:<name>")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args()

    import torch

    from portbench.harness import main

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.set_num_threads(1)
    dev = torch.device("cuda:0")
    for system in args.systems.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            res = main.run_cell(args.workload, seed, args.seconds, False, dev, system=system)
            print(json.dumps({"system": system, "seed": seed, "blocks": res["attempted"],
                              "correct": res["correct"], "checks": res["checks"],
                              "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                              "run_s": time.perf_counter() - t0}), flush=True)
