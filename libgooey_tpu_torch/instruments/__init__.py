from libgooey_tpu_torch.instruments import bass, common, hihat2, kick, snare, tom2

__all__ = ["bass", "common", "hihat2", "kick", "snare", "tom2"]
