from libgooey_tpu_torch.effects import feedback_waveshaper, freeze, limiter, waveshaper

__all__ = ["feedback_waveshaper", "freeze", "limiter", "waveshaper"]
