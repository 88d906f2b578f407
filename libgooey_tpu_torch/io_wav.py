"""Minimal WAV read/write (16/24-bit PCM and 32-bit float), numpy-based (the
port's own copy of libgooey_tpu/io_wav.py).

Replaces the reference's `hound` usage (src/bounce.rs:80-133 writes 16/24-bit
int WAV; src/mixer/stereo_buffer.rs reads WAV into sample buffers).  No
external dependencies: RIFF chunks via struct/numpy.
"""

from __future__ import annotations

import struct

import numpy as np


def write_wav(path, samples: np.ndarray, sample_rate: int, bits: int = 16):
    """Write ``samples`` — shape ``[channels, frames]`` or ``[frames]`` — to
    a WAV file.  bits: 16 or 24 (PCM) or 32 (IEEE float)."""
    data = np.asarray(samples, np.float32)
    if data.ndim == 1:
        data = data[None, :]
    channels, frames = data.shape
    interleaved = data.T.reshape(-1)

    if bits == 16:
        fmt_tag, block = 1, 2 * channels
        pcm = np.clip(np.round(interleaved * 32767.0), -32768, 32767).astype("<i2")
        payload = pcm.tobytes()
    elif bits == 24:
        fmt_tag, block = 1, 3 * channels
        scaled = np.clip(np.round(interleaved * 8388607.0), -8388608, 8388607).astype(
            "<i4"
        )
        b = scaled.astype("<i4").tobytes()
        arr = np.frombuffer(b, np.uint8).reshape(-1, 4)
        payload = arr[:, :3].tobytes()
    elif bits == 32:
        fmt_tag, block = 3, 4 * channels
        payload = interleaved.astype("<f4").tobytes()
    else:
        raise ValueError(f"unsupported bit depth {bits}")

    byte_rate = sample_rate * block
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(payload)))
        f.write(b"WAVEfmt ")
        f.write(
            struct.pack(
                "<IHHIIHH", 16, fmt_tag, channels, int(sample_rate), int(byte_rate),
                block, bits,
            )
        )
        f.write(b"data")
        f.write(struct.pack("<I", len(payload)))
        f.write(payload)


def read_wav(path):
    """Read a WAV file → ``(samples[channels, frames] float32, sample_rate)``."""
    with open(path, "rb") as f:
        riff = f.read(12)
        if riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError("not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, size = struct.unpack("<4sI", hdr)
            chunk = f.read(size + (size & 1))[:size]
            if cid == b"fmt ":
                fmt = struct.unpack("<HHIIHH", chunk[:16])
            elif cid == b"data":
                data = chunk
        if fmt is None or data is None:
            raise ValueError("missing fmt/data chunk")
        tag, channels, rate, _brate, _block, bits = fmt
        if tag == 3 and bits == 32:
            x = np.frombuffer(data, "<f4").astype(np.float32)
        elif tag == 1 and bits == 16:
            x = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
        elif tag == 1 and bits == 24:
            raw = np.frombuffer(data, np.uint8).reshape(-1, 3)
            ints = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
            x = ints.astype(np.float32) / 8388608.0
        elif tag == 1 and bits == 32:
            x = np.frombuffer(data, "<i4").astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"unsupported WAV format tag={tag} bits={bits}")
        return x.reshape(-1, channels).T.copy(), rate
