"""Counter-based deterministic noise, and the host generators
(port of libgooey_tpu/core/rng.py).

The device white sources are a stateless integer mix of ``(seed, counter)``
where the counter is samples-since-trigger.  They must match the JAX package
bit for bit, on the CPU and on CUDA: one wrong bit changes the kick's click
and pink layers by O(1).  ``XorShift32`` and ``XorShift64Star`` are plain host
Python; the first's draws decide the granulator's spawns, so both match
bit for bit.

PyTorch's ``uint32`` lacks shifts and wrapping multiplies on some backends,
so 32-bit unsigned arithmetic is emulated in ``int64`` with ``& 0xFFFFFFFF``.
Products are split into 16-bit halves so that no intermediate leaves the
signed 64-bit range (a wrapping signed multiply would be undefined in C++).
"""

from __future__ import annotations

import torch

#: Default seed (same value as the JAX package).
DEFAULT_SEED = 0x9ABCDEF0

_MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF


def _u32(x) -> torch.Tensor:
    """Integer tensor -> int64 holding its uint32 bit pattern (two's complement
    reinterpretation for negative int32 input, as ``astype(uint32)``)."""
    x = torch.as_tensor(x)
    return x.to(torch.int64) & _MASK32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for x in [0, 2^32) and a 32-bit constant c."""
    lo = x * (c & _MASK16)
    hi = ((x * (c >> 16)) & _MASK16) << 16
    return (lo + hi) & _MASK32


def add_mul32(x: torch.Tensor, y: torch.Tensor, c: int) -> torch.Tensor:
    """``(x + y * c) mod 2^32`` for uint32 patterns held in int64 (hihat2's
    salted counter ``n + salt * 0x9E3779B9``)."""
    return (_u32(x) + _mul32(_u32(y), c)) & _MASK32


def mix32(x) -> torch.Tensor:
    """A murmur3-style 32-bit finalizer: bijective avalanche mix."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def hash2(counter, seed) -> torch.Tensor:
    """Mix a counter with a seed into decorrelated 32 bits (int64-held).

    An integer seed is mixed on the host, so no scalar is copied to the
    device (a blocking copy would stall the launch queue)."""
    c = _u32(counter)
    s = _u32(seed)
    # golden-ratio sequence offset decorrelates consecutive seeds
    s_mix = mix32((_mul32(s, 0x9E3779B9) + 0x85EBCA6B) & _MASK32)
    if s_mix.dim() == 0 and s_mix.device.type == "cpu":
        s_mix = int(s_mix)
    return mix32(c ^ s_mix)


def white(counter, seed=DEFAULT_SEED) -> torch.Tensor:
    """White noise in [-1, 1] (float32) from an integer counter.

    Uses the top 24 bits so every value is exactly representable in float32.
    The divisor is a tensor on the counter's device: CUDA divides by a host
    scalar as a multiply by its reciprocal, which is not bit-exact.
    """
    bits = hash2(counter, seed) >> 8
    denom = torch.full((), float((1 << 24) - 1), dtype=torch.float32,
                       device=bits.device)
    norm = bits.to(torch.float32) / denom
    return norm * 2.0 - 1.0


def white_from_sample_index(sample_index, seed=DEFAULT_SEED) -> torch.Tensor:
    """Noise-waveform oscillator source: hash of the (integer) sample index.

    Negative indices (not yet triggered) still produce defined values;
    callers gate by envelope."""
    return white(torch.as_tensor(sample_index).to(torch.int32), seed)


# --- host-side sequential generator (control rate) ---------------------------


class XorShift32:
    """Sequential xorshift32 as used by the granulator's spawn scheduler
    (granulator.rs:833-867; libgooey_tpu/core/rng.py:79-96): host Python,
    the same draws bit for bit."""

    def __init__(self, seed: int = 0x12345678):
        self.state = (seed & _MASK32) or 1

    def next_u32(self) -> int:
        x = self.state
        x ^= (x << 13) & _MASK32
        x ^= x >> 17
        x ^= (x << 5) & _MASK32
        self.state = x
        return x

    def next_f32(self) -> float:
        """Uniform in [0, 1) from the top 24 bits."""
        return (self.next_u32() >> 8) / float(1 << 24)


_MASK64 = 0xFFFFFFFFFFFFFFFF


class XorShift64Star:
    """Sequential xorshift64* (the reference's pink-noise source,
    pink_noise.rs:67-79; libgooey_tpu/core/rng.py:99-118): host Python, the
    same 64-bit draws bit for bit, wrapped with masks."""

    MULT = 0x2545F4914F6CDD1D

    def __init__(self, seed: int = 0x123456789ABCDEF0):
        self.state = seed & _MASK64

    def next_u64(self) -> int:
        x = self.state
        x ^= x >> 12
        x = (x ^ (x << 25)) & _MASK64
        x ^= x >> 27
        self.state = x
        return (x * self.MULT) & _MASK64

    def next_white(self) -> float:
        """White sample in [-1, 1] from the top 24 bits."""
        return (self.next_u64() >> 40) / float((1 << 24) - 1) * 2.0 - 1.0
