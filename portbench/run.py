#!/usr/bin/env python3
"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``libgooey_tpu_torch``; see
``portbench/README.md``."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    # caches at fixed paths inside the checkout, before torch is imported;
    # libraries that could pull in JAX are told not to
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # one core for the run's process and every thread it starts: the host
    # sets the pace of these cells, and a process left to move between
    # cores ran its blocks at two speeds
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
    sys.path.insert(0, ROOT)
    from portbench.harness import main

    sys.exit(main.main())
