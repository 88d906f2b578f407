"""The additive triangle's redesign (``csrc/triangle.cuh``), checked on the
CPU: the host's taper threshold against the division it replaces, a float32
emulation of the kernels' split loop against the plain version bit for bit,
and the launch arguments that carry the threshold.

The split loop: the leading untapered, active terms take their gain from a
table of ``1.0f / (h*h)`` (the plain version's division with a taper of
exactly 1), the taper test ``ratio > 0.75`` becomes ``f*h >= T`` with no
division, and the walk stops at the first inactive term after one
``acc + 0.0f``.  Each claim holds for every float32 input, so the test feeds
the edge frequencies (NaN, +-inf, +-0, negative, subnormal, T/h, nyquist/h,
the max_h steps) and compares bits, with no tolerance.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from libgooey_tpu_torch.ops import bank_kernels as bk

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

RATES = (22050.0, 44100.0, 48000.0, 96000.0)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("sr", RATES)
def test_taper_threshold_equals_the_division(sr):
    """``x >= T`` equals ``f32(x / nyquist) > 0.75`` at every float32 within
    2^16 steps of 0.75 * nyquist, at nyquist sr/2 and sr; T is the float
    after f32(0.75 * nyquist) at these rates."""
    for nyq in (np.float32(sr / 2.0), np.float32(sr)):
        T = np.float32(bk.taper_threshold(float(nyq)))
        mid = np.float32(np.float32(0.75) * nyq)
        x = (mid.view(np.int32) + np.arange(-2**16, 2**16 + 1, dtype=np.int32)).view(np.float32)
        assert np.array_equal(x >= T, (x / nyq) > np.float32(0.75))
        assert T == np.nextafter(mid, np.float32(np.inf))
        assert np.float32(T / nyq) > np.float32(0.75) >= np.float32(np.nextafter(T, mid) / nyq)


def _split_triangle(idx, freq, sample_rate, max_harmonics, acc0=0.0):
    """The kernels' loop (triangle.cuh), element by element as masks over
    float32 tensors: the plain version's sin1, cos2x2 and max_h, the gain
    table, k1 by the estimate and the two corrections, the table's steps,
    then the plain step until the first inactive term, one ``acc + 0.0f``
    and the break.  ``acc0``: the sum's start (the plain version's +0)."""
    f32 = torch.float32
    n_terms = (max_harmonics + 1) // 2
    nyq = torch.full((), sample_rate / 2.0, dtype=f32)
    T = torch.tensor(bk.taper_threshold(float(nyq)), dtype=f32)
    theta = idx * freq * (bk.TWO_PI / sample_rate)
    sin1 = torch.sin(theta)
    cos2x2 = 2.0 * torch.cos(2.0 * theta)
    max_h = torch.floor(nyq / torch.clamp(freq, min=1e-6))
    n_gain = min(n_terms, 256)
    gain = [torch.tensor(1.0, dtype=f32) / (torch.tensor(2.0 * k + 1.0, dtype=f32) ** 2)
            for k in range(n_gain)]

    def untapered(k):
        h = torch.tensor(2.0 * k + 1.0, dtype=f32)
        hf = freq * h
        return (h <= max_h) & (hf <= nyq) & (hf < T)

    # U[k]: term k untapered and active, k < n_gain (a False row past them)
    U = torch.stack([untapered(k) for k in range(n_gain)]
                    + [torch.zeros_like(freq, dtype=torch.bool)])

    def at(k):
        return torch.gather(U, 0, k.clamp(0, n_gain)[None])[0]

    # k1: the estimate from max_h, clamped, then corrected both ways
    est = torch.ceil((0.75 * max_h - 1.0) * 0.5)
    k1 = torch.clamp(torch.nan_to_num(est, nan=0.0), 0.0, float(n_gain)).to(torch.int64)
    k1 = torch.where(torch.isnan(freq), 0, k1)
    while bool(((k1 > 0) & ~at(k1 - 1)).any()):
        k1 = k1 - ((k1 > 0) & ~at(k1 - 1)).to(torch.int64)
    while bool(((k1 < n_gain) & at(k1)).any()):
        k1 = k1 + ((k1 < n_gain) & at(k1)).to(torch.int64)

    prev, curr = -sin1, sin1
    acc = torch.full_like(sin1, acc0)
    done = torch.zeros_like(freq, dtype=torch.bool)
    for k in range(n_terms):
        h = torch.tensor(2.0 * k + 1.0, dtype=f32)
        hf = freq * h
        table = (k < k1) & ~done
        if k < n_gain:
            acc = torch.where(table, acc + gain[k] * curr, acc)
        rest = (k >= k1) & ~done
        active = (h <= max_h) & (hf <= nyq)
        ratio = hf / nyq
        t = (ratio - 0.75) * 4.0
        taper = torch.where(ratio > 0.75, 1.0 - t * t, 1.0)
        g = taper / (h * h)
        acc = torch.where(rest & active, acc + g * curr, acc)
        acc = torch.where(rest & ~active, acc + 0.0, acc)
        done = done | (rest & ~active)
        prev, curr = curr, cos2x2 * curr - prev
    return acc


@pytest.mark.parametrize("sr", [44100.0, 96000.0])
@pytest.mark.parametrize("max_harmonics", chip_smoke.TRI_EDGE_HARMONICS)
def test_split_loop_equals_the_plain_version_at_the_edges(max_harmonics, sr):
    idx, freq = chip_smoke.triangle_edge_args("cpu", 512, sr)
    got = _split_triangle(idx, freq, sr, max_harmonics)
    want = bk.triangle_additive_bank_plain(idx, freq, sr, max_harmonics)
    assert torch.equal(_bits(got), _bits(want))
    if max_harmonics >= 64:   # the tapered band and the break both ran
        T = bk.taper_threshold(float(np.float32(sr / 2.0)))
        assert bool((freq * 63.0 >= T).any()) and bool(torch.isfinite(want).any())


@pytest.mark.parametrize("ulps", [-1, 1])
def test_a_threshold_one_ulp_off_changes_no_bit(monkeypatch, ulps):
    """The taper is exactly 1.0f for a ratio within ~4.3e-5 above 0.75, so
    a term just either side of T gets the same gain from the table as from
    the plain step: T one float away gives the same bits (a mutation that
    moves it so little cannot be caught, and is no fault)."""
    idx, freq = chip_smoke.triangle_edge_args("cpu", 512, 44100.0)
    want = bk.triangle_additive_bank_plain(idx, freq, 44100.0, 192)
    T = np.float32(bk.taper_threshold(22050.0))
    moved = float(np.nextafter(T, np.float32(np.inf * ulps)))
    monkeypatch.setattr(bk, "taper_threshold", lambda nyquist: moved)
    assert torch.equal(_bits(_split_triangle(idx, freq, 44100.0, 192)), _bits(want))


def test_split_loop_keeps_the_sign_of_a_minus_zero_sum():
    """Started from -0, the split loop's single ``acc + 0.0f`` at the break
    gives what the plain loop's many give (+0) where no term is active,
    and -0 where the walk ends without an inactive term."""
    idx = torch.tensor([[100.0, 100.0, 0.0]])
    freq = torch.tensor([[float("nan"), 1e30, 0.0]])
    got = _split_triangle(idx, freq, 44100.0, 64, acc0=-0.0)
    assert torch.equal(_bits(got), _bits(torch.tensor([[0.0, 0.0, 0.0]])))
    got = _split_triangle(idx, freq, 44100.0, 0, acc0=-0.0)
    assert torch.equal(_bits(got), _bits(torch.tensor([[-0.0, -0.0, -0.0]])))


def _recorded(monkeypatch, fn, *args, **kw):
    calls = []
    monkeypatch.setattr(bk, "_on_cuda", lambda name, t: True)
    monkeypatch.setattr(bk, "_launch", lambda name, device, entry, *a: calls.append((entry, a)))
    launches = fn.launches
    fn(*args, **kw)
    fn.launches = launches
    (call,) = calls
    return call


@pytest.mark.parametrize("sr,mh,terms", [(44100.0, 64, 32), (96000.0, 192, 96),
                                         (22050.0, 1, 1), (48000.0, 0, 0)])
def test_triangle_launch_passes_the_taper_threshold(monkeypatch, sr, mh, terms):
    """``triangle_additive_bank`` passes 2 pi / sr, the nyquist and T as
    float32 values, then the terms, V and B."""
    idx = torch.zeros(3, 100)
    entry, a = _recorded(monkeypatch, bk.triangle_additive_bank, idx, idx, sr, mh)
    nyq = float(np.float32(sr / 2.0))
    assert entry == "triangle_additive_bank_launch" and len(a) == 9
    assert a[3:] == (float(np.float32(bk.TWO_PI / sr)), nyq, bk.taper_threshold(nyq), terms,
                     3, 100)
    assert all(x == float(np.float32(x)) for x in a[3:6])


def test_kit_sources_passes_the_taper_threshold():
    """The kick's and the snare's sources phases carry T after their other
    floats (kick_a's 17th, snare_a's 5th), as voice_kernels.cu reads it."""
    from libgooey_tpu_torch.ops import voice_kernels as vk

    sources, _ = chip_smoke.kit_phases("cpu", dict.fromkeys(chip_smoke.PRODUCT_KIT, 1), 64)
    T = bk.taper_threshold(float(np.float32(chip_smoke.SR / 2.0)))
    floats = {ph.name: vk._specs(ph, 1, 64)[2] for ph in sources}
    assert floats["kick_a"][16] == T and len(floats["kick_a"]) == 17
    assert floats["snare_a"][4] == T and len(floats["snare_a"]) == 5
    assert floats["kick_a"][2] == floats["snare_a"][2] == float(np.float32(chip_smoke.SR / 2.0))


@pytest.mark.parametrize("freq,mh,ops", [
    (100.0, 64, 10 + 4 * 32),            # every term active, none tapered
    (-100.0, 64, 10 + 4 * 32),           # a negative f: every term active
    (1000.0, 64, 10 + 4 * 11 + 10 * 3 + 1),   # h <= 21 active, 17-21 tapered
    (float("nan"), 64, 10 + 1),          # no term active
    (100.0, 0, 10),                      # no terms
    (100.0, 192, 10 + 4 * 96 + 10 * 13)])   # h >= 167 tapered
def test_triangle_bound_counts_the_terms_the_data_needs(freq, mh, ops):
    """``chip_smoke.triangle_ops``: a sample's own work, four operations an
    active term and ten more a tapered one, one add where the walk stops
    at an inactive term (44.1 kHz: T ~ 16,537.5 Hz, max_h 220 at 100 Hz and
    22 at 1 kHz)."""
    f = torch.full((2, 3), freq)
    assert chip_smoke.triangle_ops(f, 44100.0, mh) == 6 * ops


def test_kit_bodies_count_their_triangle_by_its_harmonics():
    """The kick's and the snare's sources bodies add their triangle's
    operations at their harmonics (64: 32 terms), and none at 0."""
    sources, _ = chip_smoke.kit_phases("cpu", dict.fromkeys(chip_smoke.PRODUCT_KIT, 1), 64)
    by_name = {ph.name: ph for ph in sources}
    tri = chip_smoke.TRI_OPS_SAMPLE + chip_smoke.TRI_OPS_TERM * 32
    for name in ("kick_a", "snare_a"):
        assert by_name[name].kwargs["max_harmonics"] == 64
        assert chip_smoke.kit_body_ops(by_name[name]) == chip_smoke.OPS_PER_BODY_SAMPLE[name] + tri
    assert chip_smoke.kit_body_ops(by_name["hihat2"]) == chip_smoke.OPS_PER_BODY_SAMPLE["hihat2"]
