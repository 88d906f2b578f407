from libgooey_tpu_torch.engine import engine, sequencer

__all__ = ["engine", "sequencer"]
