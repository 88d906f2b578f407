from libgooey_tpu_torch.core import constants, dsp, envelope, rng, smoother

__all__ = ["constants", "dsp", "envelope", "rng", "smoother"]
