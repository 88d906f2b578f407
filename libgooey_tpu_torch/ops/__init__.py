from libgooey_tpu_torch.ops import bank_kernels, filters, morph, noise, osc, oversample, scan

__all__ = ["bank_kernels", "filters", "morph", "noise", "osc", "oversample", "scan"]
