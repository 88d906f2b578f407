from libgooey_tpu_torch.core import constants, dsp, envelope, max_curve, rng, smoother

__all__ = ["constants", "dsp", "envelope", "max_curve", "rng", "smoother"]
