from libgooey_tpu_torch.parallel import mesh

__all__ = ["mesh"]
