"""Kick tour: the four presets, a velocity ladder, and a pitch-bend sweep
(port of examples/kick.py; mirrors the reference's examples/kick.rs, preset
cycling + live param tweaks)."""

import dataclasses

import numpy as np

from libgooey_tpu_torch import card_or
from libgooey_tpu_torch.engine.engine import Engine
from libgooey_tpu_torch.examples import cut
from libgooey_tpu_torch.instruments.kick import KickConfig
from libgooey_tpu_torch.io_wav import write_wav


def main(out_path: str = "/tmp/gooey_kick.wav", quick: bool = False, *, device=None,
         blocks=None):
    L = (lambda n: max(n // 16, 2048)) if quick else (lambda n: n)
    presets = (KickConfig.tight, KickConfig.punch_preset, KickConfig.loose, KickConfig.dirt)
    velocities = (0.25, 0.5, 0.75, 1.0)
    bends = (0.1, 0.4, 0.7, 1.0)
    lengths = iter(cut([L(22050)] * 4 + [L(11025)] * 8, blocks))
    engine = Engine(44100.0, device=card_or(device, "kick example"))
    engine.add_instrument("kick", "kick")
    sections = []

    # 1. each preset, one hit
    for preset in presets:
        engine.set_config("kick", preset())
        engine.trigger("kick", 0.9)
        sections.append(engine.render_mono(next(lengths)))

    # 2. velocity ladder on the punch preset (sqrt-velocity amplitude law)
    engine.set_config("kick", KickConfig.punch_preset())
    for vel in velocities:
        engine.trigger("kick", vel)
        sections.append(engine.render_mono(next(lengths)))

    # 3. pitch-env depth sweep (the kick.rs up/down arrow control)
    base = KickConfig.tight()
    for bend in bends:
        engine.set_config("kick", dataclasses.replace(base, pitch_envelope_amount=bend))
        engine.trigger("kick", 0.8)
        sections.append(engine.render_mono(next(lengths)))

    audio = np.concatenate(sections)
    write_wav(out_path, audio, 44100)
    print(f"wrote {out_path} ({len(audio)} samples, peak {np.abs(audio).max():.3f})")
    return out_path


def play(audio: np.ndarray, sample_rate: float = 44100.0):
    """Audible playback where the optional sounddevice backend exists
    (engine_output.rs realtime path); no-op headless."""
    from libgooey_tpu_torch.engine import output as out_mod

    if not out_mod.sounddevice_available():
        print("sounddevice not installed - skipping audible playback")
        return

    class BufferEngine:
        block = 512

        def __init__(self, mono):
            self.mono, self.pos = mono, 0

        def render(self, frames):
            seg = self.mono[self.pos:self.pos + frames]
            self.pos += frames
            seg = np.pad(seg, (0, frames - len(seg)))
            return np.repeat(seg, 2).astype(np.float32)

    out = out_mod.EngineOutput(prefetch_blocks=4)
    out.initialize(sample_rate)
    out.create_stream_with_engine(BufferEngine(audio))
    stream = out_mod.RealtimeStream(out, backend="sounddevice")
    stream.start()
    import time
    time.sleep(len(audio) / sample_rate + 0.2)
    stream.stop()
    print(f"played {len(audio)} samples; overruns: {out.take_overrun_count()}")


if __name__ == "__main__":
    import sys

    path = main(quick="--quick" in sys.argv)
    if "--play" in sys.argv:
        from libgooey_tpu_torch.io_wav import read_wav

        data, sr = read_wav(path)          # [channels, frames]
        play(np.asarray(data, np.float32).mean(axis=0), sr)
