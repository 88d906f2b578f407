"""A small cell for the CPU tests: the unit kit (2, 2, 2, 1, 1 voices) at
64-sample blocks, every voice struck within its first blocks."""

import torch

UNIT = {"kick": 2, "snare": 2, "hihat2": 2, "tom2": 1, "bass": 1}
OVERRIDES = {
    "config": {"voices": UNIT, "block_size": 64},
    "traffic": {"lag_max_s": 0.004, "trace_blocks": 1, "client": {"chunk_blocks": 4}},
}
CPU = torch.device("cpu")
