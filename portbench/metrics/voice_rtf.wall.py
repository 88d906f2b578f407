"""voice_rtf.wall: voices x audio seconds of the window's blocks before
its traced stretch (every block of an untraced window) over the wall
seconds they took, each stretch closed by a synchronization: the host's
pace of the render."""


def read(ctx):
    w, cfg = ctx.window, ctx.config
    if w.pre_seconds <= 0.0 or w.pre_blocks <= 0:
        return None
    voices = sum(cfg["voices"].values())
    return voices * w.pre_blocks * cfg["block_size"] / cfg["sample_rate"] / w.pre_seconds
