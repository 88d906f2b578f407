"""The examples on the port (port of the repo's ``examples/`` scripts).

Each module mirrors the script of the same name: ``main`` keeps that
script's arguments and adds the keyword-only ``device`` (``None`` is the
card; with no card it raises unless ``"cpu"`` is asked for).  A script whose
``quick`` render is longer than 16 blocks also takes the keyword-only
``blocks``: the render's length in 512-sample blocks, cut from every section
in proportion (:func:`cut`), so that a CPU run stays short.  Run one with
``python -m libgooey_tpu_torch.examples.kick`` (on the card) or call its
``main(device="cpu")``.
"""

from __future__ import annotations

BLOCK = 512


def cut(lengths, blocks=None):
    """Section lengths (samples) cut in proportion to ``blocks`` blocks in
    all, each keeping at least one sample (so each still renders a block);
    ``None`` keeps them as they are."""
    lengths = [int(n) for n in lengths]
    if blocks is None:
        return lengths
    total = sum(lengths)
    return [max(1, n * int(blocks) * BLOCK // total) for n in lengths]
