from libgooey_tpu_torch.instruments import common, kick

__all__ = ["common", "kick"]
