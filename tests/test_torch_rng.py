"""The port's counter hash must match the JAX package bit for bit: one wrong
bit changes the kick's click and pink layers by O(1)."""

import numpy as np
import pytest
import torch

from libgooey_tpu.core import rng as jrng
from libgooey_tpu.ops import osc as josc

from libgooey_tpu_torch.core import rng as trng
from libgooey_tpu_torch.ops import osc as tosc


def _counters():
    rs = np.random.RandomState(0)
    edges = [0, 1, -1, 2**31 - 1, -(2**31), 2**30, -(2**30), 2**24, 2**24 + 1]
    return np.concatenate([
        rs.randint(-(2**31), 2**31 - 1, 50_000), np.arange(-3000, 3000),
        np.arange(2**30 - 600, 2**30 + 600), edges]).astype(np.int32)


@pytest.mark.parametrize("seed", [jrng.DEFAULT_SEED, 0, 1, 12345, 0xFFFFFFFF])
def test_white_is_bit_exact(seed):
    c = _counters()
    want = np.asarray(jrng.white(c.astype(np.uint32), seed))
    got = trng.white(torch.from_numpy(c), seed).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_hash_and_mix_are_bit_exact():
    c = _counters()
    np.testing.assert_array_equal(
        trng.mix32(torch.from_numpy(c)).numpy(),
        np.asarray(jrng.mix32(c.astype(np.uint32))).astype(np.int64))
    np.testing.assert_array_equal(
        trng.hash2(torch.from_numpy(c), jrng.DEFAULT_SEED).numpy(),
        np.asarray(jrng.hash2(c.astype(np.uint32), jrng.DEFAULT_SEED)).astype(np.int64))


def test_noise_oscillator_is_bit_exact():
    """``osc.noise`` floors a float sample index, including the huge indices
    of never-triggered voices."""
    idx = np.concatenate([np.arange(-50, 3000), 2**30 + np.arange(0, 2000)]).astype(np.float32)
    want = np.asarray(josc.noise(idx))
    got = tosc.noise(torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
