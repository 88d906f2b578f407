"""libgooey_tpu_torch: the PyTorch/CUDA port of libgooey_tpu.

The JAX package ``libgooey_tpu`` is the reference; this package mirrors its
layout module for module (``core/``, ``ops/``, ``effects/``,
``instruments/``, ``engine/``) so each counterpart sits at the same relative
path.  It imports ``torch`` and numpy and never ``jax``.

Idiom:

* plain functions on tensors, with the device taken from the inputs or named
  explicitly; state is ``NamedTuple``s of tensors with the JAX field names;
* voices stay the batch axis and every public function keeps the JAX
  package's ``[V, B]`` layout;
* PyTorch runs eagerly, so ``jit`` has no counterpart and ``lax.scan`` over
  blocks is a Python loop;
* every computation that the JAX package runs as a Pallas kernel is a CUDA
  kernel written by hand (``csrc/*.cu``, bound in ``ops/bank_kernels.py``,
  ``ops/bus_kernels.py``, ``ops/plate_kernels.py``,
  ``ops/voice_kernels.py`` and ``ops/grain_kernels.py``, listed in
  ``ops/kernels.py``).  A CUDA tensor launches the kernel or raises; a CPU
  tensor takes the kernel's plain PyTorch version.

What is ported so far is the engine's whole main path
(``bench_configs.build_full_kit``: the five headline families and the
global bus of all seven effects with the compressor's sidechain), the
product block (``bench_configs.bench_onchip_product_block``: small banks
through the kit kernels, ``ops/voice.py``, then the nine-entry effect
chain, ``mixer/chain.py``), the granulator and sampler racks with their
hosts (``bench_configs.bench_granulator_sampler_4k``) and the whole
``Engine`` of the JAX package (``engine/engine.py``: all eight families,
LFO routes, poly notes and chords with the host's lane allocator, preset
blends, the MIDI-out queue, the bounce methods and the source scatter),
the loop mixer with its streamed WSOLA and the submix graph (``mixer/``),
and ``GooeyEngine``, the product engine behind the C API (``gooey.py``,
with its performance recorder, ``performance.py``, and the realtime output
adapter, ``engine/output.py``), and the product API above it: the C API's
integer-id dispatch (``capi.py``, one engine per handle, on the card unless
``LIBGOOEY_TPU_TORCH_DEVICE`` asks for the CPU) with the C shim that embeds
it (``native/``: ``gooey_shim.cpp`` and its build), the program DSL
(``dsl.py``), MIDI input, files and dispatch (``midi.py``) and the legacy
8th-note sequencer (``engine/legacy_sequencer.py``), the visualization
(``visualization.py``: the capture ring, the spectrogram on ``torch.fft``,
the offscreen scope), the terminal scope (``tui.py``) and the examples
(``examples/``, each ``python -m libgooey_tpu_torch.examples.<name>``),
and voice sharding over ``torch.distributed`` (``parallel/mesh.py``: one
process a rank, the mix summed over the group).  What ROADMAP.md lists as
TPU-only is not ported; an entry point the port lacks raises
``NotImplementedError``.
"""

__version__ = "0.1.0"

from libgooey_tpu_torch.core.constants import DEFAULT_BLOCK_SIZE, DEFAULT_SAMPLE_RATE

__all__ = [
    "DEFAULT_SAMPLE_RATE",
    "DEFAULT_BLOCK_SIZE",
]


def card_or(device, what: str):
    """``device`` as a ``torch.device``; ``None`` means the card.  Asking for
    CUDA where no card is present raises, naming ``what``: the CPU is only
    taken when the caller asks for it (``device="cpu"``)."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}: no CUDA device available (pass device='cpu' to run on "
                           "the CPU)")
    return dev


def not_ported(what: str) -> NotImplementedError:
    """The error raised by every entry point the port does not cover yet."""
    return NotImplementedError(
        f"{what} is not ported to libgooey_tpu_torch yet; see ROADMAP.md "
        "(Queue A for modules, Queue B for kernels)")
