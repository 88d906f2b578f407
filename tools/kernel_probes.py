#!/usr/bin/env python3
"""Copies of the kernel sources with parts of ``ws4_bank`` cut out, for
timing those parts alone on the card with ``tools/torch_kernel_ab.py``.

    python3 tools/kernel_probes.py OUT_DIR [CSRC]

Writes one directory per probe under ``OUT_DIR`` (inside the copied repo,
e.g. ``chip_checkout/``), each a copy of ``CSRC`` (default: this tree's
``libgooey_tpu_torch/csrc``) with lines of ``ws4_bank_kernel`` replaced:
``walks_only`` (no copies, no shaper: the up- and down-walks on whatever
shared memory holds), ``up_only`` and ``down_only`` (one walk), and
``shape_copy`` (no walks: the shaper with the drive's gain and the
copies).  Their outputs are wrong; only their times mean anything.  Pass
the directories to ``tools/torch_kernel_ab.py --only ws4_bank``.
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

NO_COPIES = [
    ("for (int c = 0; c < 2; ++c) stage_in(src, ring + c * 2 * s.tile(), s, c, n_chunks, p);",
     ";"),
    ("stage_in(src, ring + ((j + 2) % kWsRing) * 2 * s.tile(), s, j + 2, n_chunks, p);", ";"),
    ("if (j >= 3) stage_out(dst, outs + ((j - 3) & 1) * s.tile(), s, j - 3, p);", ";"),
    ("if (warp >= 2) stage_out(dst, outs + ((n_chunks - 1) & 1) * s.tile(), s, n_chunks - 1, p);",
     ";"),
]
NO_SHAPER = [("if (j >= 1 && j <= n_chunks) {", "if (false) {")]
NO_UP = [("if (walks && j < n_chunks) {", "if (false) {")]
NO_DOWN = [("if (walks && j >= 2) {", "if (false) {")]
PROBES = {
    "walks_only": NO_COPIES + NO_SHAPER,
    "up_only": NO_COPIES + NO_SHAPER + NO_DOWN,
    "down_only": NO_COPIES + NO_SHAPER + NO_UP,
    "shape_copy": NO_UP + NO_DOWN,
}


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    if not 1 <= len(args) <= 2:
        print("usage: kernel_probes.py OUT_DIR [CSRC]", file=sys.stderr)
        return 2
    out_root = Path(args[0])
    src = Path(args[1]) if len(args) > 1 else ROOT / "libgooey_tpu_torch/csrc"
    for name, edits in PROBES.items():
        text = (src / "bank_kernels.cu").read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the source no longer holds {old!r} once")
            text = text.replace(old, new)
        out = out_root / name
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(src, out)
        (out / "bank_kernels.cu").write_text(text)
        print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
