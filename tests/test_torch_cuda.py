"""The CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU with nvcc (marker ``cuda``) and skips
elsewhere.  The card's machine has no JAX, so run these without the suite's
conftest, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from libgooey_tpu_torch.core.smoother import SmootherBank, smoothing_coeff
from libgooey_tpu_torch.effects import compressor, delay, reverb_plate, reverb_spring, saturation
from libgooey_tpu_torch.engine import engine
from libgooey_tpu_torch.instruments import kick
from libgooey_tpu_torch.ops import bank_kernels as bk
from libgooey_tpu_torch.ops import bus_kernels as bus
from libgooey_tpu_torch.ops import kernels, plate_kernels, ringbuf

pytestmark = pytest.mark.cuda

SR = 44100.0


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _cases(dev, V, B, seed=0):
    """(name, args, kwargs) for each wrapper, inputs from a numpy seed."""
    rs = np.random.RandomState(seed)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

    return [
        ("affine1_bank", (t(np.full((V, B), -3.0e38)), t(rs.uniform(0.9, 1.0, (V, B))),
                          t(0.02 * rs.randn(V, B)), t(0.1 * rs.randn(V))), {}),
        ("pink_bank", (t(rs.uniform(-1, 1, (V, B))), t(rs.rand(V, B) < 0.01, torch.bool),
                       t(0.1 * rs.randn(V, 3))),
         dict(poles=(0.99765, 0.963, 0.57), gains=(0.099046, 0.2965164, 1.0526913),
              direct=0.1848, outg=0.11)),
        ("svf_bank", (t(rs.randn(V, B)), t(0.01 + 0.5 * rs.rand(V, B)),
                      t(0.3 + 0.6 * rs.rand(V, B)), t(rs.rand(V, B) < 0.01, torch.bool),
                      t(0.1 * rs.randn(V)), t(0.1 * rs.randn(V))), {}),
        ("env_follow_bank", (t(np.abs(rs.randn(V, B))), t(rs.rand(V, B) < 0.1, torch.bool),
                             t(np.abs(rs.randn(V)))), dict(att=0.9776, rel=0.99981)),
        ("fbws_bank", (t(3.0 * rs.randn(V, B)),
                       t(np.where(rs.rand(V, B) < 0.05, -1.0, 0.2 + 2.8 * rs.rand(V, B))),
                       t(0.1 * rs.randn(bk.FBWS_S_IN, V))), {}),
        ("ws4_bank", (t(0.6 * rs.randn(V, B)),
                      t(np.where(rs.rand(V, 1) < 0.1, 1.0, 1.0 + 9.0 * rs.rand(V, B))),
                      t(0.1 * rs.randn(bk.FBWS_S_IN, V))), {}),
        ("linrec2_bank", _resonator_rows(rs, t, V, B), {}),
        ("triangle_additive_bank",
         (t(rs.randint(0, 2 * int(SR), (V, 1)) + np.arange(B)[None, :]),
          t(rs.uniform(40.0, 2000.0, (V, B)))),
         dict(sample_rate=SR, max_harmonics=64)),
        ("mix_bank", _mix_args(rs, t, V, B), dict(coeff=smoothing_coeff(SR))),
    ]


def _mix_args(rs, t, V, B):
    """mix_bank arguments: audio-level voices, pans sweeping (some within
    the settle snap), gains around 1/V moving."""
    pt = rs.uniform(0.0, 1.0, V)
    pc = np.clip(pt + rs.uniform(-0.3, 0.3, V), 0.0, 1.0)
    pc[::7] = pt[::7] + 5e-5
    gt = rs.uniform(0.0, 2.0 / V, V)
    return (t(0.5 * rs.randn(V, B)), t(pc), t(pt), t(gt + rs.uniform(-0.5, 0.5, V) / V), t(gt))


def _resonator_rows(rs, t, R, B):
    """linrec2_bank arguments: DF-I band-pass feedback at high Q with
    trigger resets, white input."""
    w = 2 * np.pi * rs.uniform(150.0, 350.0, (R, 1)) / SR
    alpha = np.sin(w) / (2 * rs.uniform(1.0, 8.0, (R, 1)))
    keep = np.where(rs.rand(R, B) < 0.01, 0.0, 1.0)
    a11 = (2 * np.cos(w) / (1 + alpha)) * keep
    a12 = -((1 - alpha) / (1 + alpha)) * keep
    return (t(a11), t(a12), t(keep), t(np.zeros((R, B))), t(0.002 * rs.randn(R, B)),
            t(np.zeros((R, B))), t(0.01 * rs.randn(R)), t(0.01 * rs.randn(R)))


@pytest.mark.parametrize("V,B", [(130, 128), (4096, 512)])
def test_kernels_match_plain_versions(dev, V, B):
    for name, args, kw in _cases(dev, V, B):
        got = getattr(bk, name)(*args, **kw)
        want = getattr(bk, name + "_plain")(*args, **kw)
        torch.cuda.synchronize()
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape and g.device == w.device
            assert float((g - w).abs().max()) <= 1e-5, f"{name} output {i}"


def test_each_launch_counts_once(dev):
    kernels.reset_launch_counts()
    for name, args, kw in _cases(dev, 64, 32):
        getattr(bk, name)(*args, **kw)
        getattr(bk, name + "_plain")(*args, **kw)
    assert kernels.launch_counts() == {n: int(n in bk.KERNELS) for n in kernels.KERNELS}


def test_wrappers_reject_bad_inputs(dev):
    a = torch.zeros(8, 16, device=dev)
    y0 = torch.zeros(8, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        bk.affine1_bank(a, a.t().contiguous().t(), a, y0)
    with pytest.raises(TypeError, match="dtype"):
        bk.affine1_bank(a, a.double(), a, y0)
    with pytest.raises(ValueError, match="shape"):
        bk.affine1_bank(a, a, a, torch.zeros(7, device=dev))
    with pytest.raises(ValueError, match="expected cuda"):
        bk.affine1_bank(a, a, a.cpu(), y0)


def _svf_rows(rs, t, R, B, resets=True):
    """svf_bank arguments: noise through swept cutoffs, trigger resets (and
    on the first and the last sample of every 7th row) or no mask."""
    g = np.tan(np.pi * rs.uniform(20.0, 9000.0, (R, B)) / SR)
    h = 1.0 / (1.0 + 2.0 * 0.55 * g + g * g)
    reset = rs.rand(R, B) < 0.01
    reset[::7, 0] = reset[::7, -1] = True
    return (t(rs.randn(R, B)), t(g), t(h), t(reset, torch.bool) if resets else None,
            t(0.1 * rs.randn(R)), t(0.1 * rs.randn(R)))


def _ws4_rows(rs, t, R, B):
    """ws4_bank arguments: noise, a drive of 1-10 moving along each row, a
    tenth of the rows at 1 (bypassed), a random packed state."""
    drive = 1.0 + 9.0 * rs.rand(R, 1) * np.linspace(0.5, 1.0, B)[None, :]
    drive[rs.rand(R) < 0.1] = 1.0
    return t(0.6 * rs.randn(R, B)), t(drive), t(0.1 * rs.randn(bk.FBWS_S_IN, R))


def _pink_rows(rs, t, R, B, resets=True):
    """pink_bank arguments and keywords: white noise, trigger resets (and on
    the first and the last sample of every 7th row) or no mask."""
    reset = rs.rand(R, B) < 0.01
    reset[::7, 0] = reset[::7, -1] = True
    return ((t(rs.uniform(-1, 1, (R, B))), t(reset, torch.bool) if resets else None,
             t(0.1 * rs.randn(R, 3))),
            dict(poles=(0.99765, 0.963, 0.57), gains=(0.099046, 0.2965164, 1.0526913),
                 direct=0.1848, outg=0.11))


def _staged_cases(dev, R, B, seed=1):
    """``(name, args, kwargs)`` of the staged kernels and ws4_bank:
    affine1_bank with a live floor (hihat2's tracker) and with none,
    svf_bank with a reset mask and without, linrec2_bank's resonator rows,
    ws4_bank's overdrive, pink_bank with a reset mask (the kick's) and
    without (hihat2's), env_follow_bank with freezes."""
    rs = np.random.RandomState(seed)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

    target = np.abs(0.5 * rs.randn(R, B))
    return [
        ("affine1_bank", (t(target), t(np.where(rs.rand(R, B) < 0.01, 0.0, 0.9995)),
                          t(0.0005 * target), t(np.abs(0.1 * rs.randn(R)))), {}),
        ("affine1_bank", (None, t(rs.uniform(-0.99, 0.99, (R, B))), t(rs.randn(R, B)),
                          t(rs.randn(R))), {}),
        ("svf_bank", _svf_rows(rs, t, R, B), {}),
        ("svf_bank", _svf_rows(rs, t, R, B, resets=False), {}),
        ("linrec2_bank", _resonator_rows(rs, t, R, B), {}),
        ("ws4_bank", _ws4_rows(rs, t, R, B), {}),
        ("pink_bank", *_pink_rows(rs, t, R, B)),
        ("pink_bank", *_pink_rows(rs, t, R, B, resets=False)),
        ("env_follow_bank", (t(np.abs(0.5 * rs.randn(R, B))), t(rs.rand(R, B) < 0.1, torch.bool),
                             t(np.abs(0.1 * rs.randn(R)))), dict(att=0.9776, rel=0.99981)),
    ]


def _assert_staged_equal_plain(cases):
    """Every output, the carried state among them (ic1/ic2, the pink poles,
    ws4's [100, V] packed state with its captures), bit for bit."""
    for name, args, kw in cases:
        got = getattr(bk, name)(*args, **kw)
        want = getattr(bk, name + "_plain")(*args, **kw)
        torch.cuda.synchronize()
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape and torch.equal(g, w), f"{name} output {i}"


@pytest.mark.parametrize("B", [512, 128, 100, 37])
@pytest.mark.parametrize("R", [1, 5, 515])
def test_staged_kernels_equal_their_plain_versions(dev, R, B):
    """Bit for bit at one row, fewer rows than SMs and a last block short of
    rows; whole 64-sample chunks, a tail chunk (B = 100) and 4-byte copies
    (B = 37)."""
    _assert_staged_equal_plain(_staged_cases(dev, R, B))


def test_staged_kernels_take_unaligned_rows(dev):
    """Contiguous inputs 4 bytes past a 16-byte boundary take the 4-byte
    copies, bit for bit."""
    R, B = 515, 128

    def shifted(a):
        return None if a is None else torch.cat([a.new_zeros(1), a.flatten()])[1:].view(a.shape)

    cases = [(name, tuple(map(shifted, args)), kw) for name, args, kw in _staged_cases(dev, R, B)]
    assert not any(bk.copies_16b(B, *args) for _, args, _ in cases)
    _assert_staged_equal_plain(cases)


def _fbws_rows(rs, t, R, B):
    """fbws_bank arguments: noise at the kick's drive, a makeup gain with
    5% of the samples bypassed, every 5th row (from the 2nd) bypassed for
    the whole block and every 7th (from the 4th) from mid-block on, a
    random packed state."""
    cs = np.where(rs.rand(R, B) < 0.05, -1.0, 0.2 + 2.8 * rs.rand(R, B))
    cs[1::5] = -1.0
    cs[3::7, B // 2:] = -1.0
    return (t((1.0 + 40.0 * rs.rand(R, 1) ** 3) * 0.3 * rs.randn(R, B)), t(cs),
            t(0.1 * rs.randn(bk.FBWS_S_IN, R)))


@pytest.mark.parametrize("R,B", [(4096, 512), (1024, 512), (515, 100), (515, 37), (5, 512),
                                 (1, 33)])
def test_fbws_bank_is_bit_equal_to_its_plain_version(dev, R, B):
    """The split chain with the DC blocker on its down-walk: the output and
    the [100, V] packed state with its captures, bit for bit, at a tail of
    rows and of the 32-sample chunk, with rows bypassed for the whole block
    and from mid-block on; also with every input 4 bytes past a 16-byte
    boundary."""
    rs = np.random.RandomState(6)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(torch.float32)

    args = _fbws_rows(rs, t, R, B)
    shifted = tuple(torch.cat([a.new_zeros(1), a.flatten()])[1:].view(a.shape) for a in args)
    for a in (args, shifted):
        got, want = bk.fbws_bank(*a), bk.fbws_bank_plain(*a)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.shape == w.shape and torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert float(got[0].abs().max()) > 0.01 and bool((got[0][1::5] == 0).all())


def _mix_rows(rs, t, V, B, kind):
    """mix_bank arguments: voices of noise, pans over [0.2, 0.8] and gains
    1/V held at their targets (``settled``), every other voice sweeping
    (``half``) or every voice sweeping (``unsettled``: pans to their mirror
    image, gains from 1.5/V)."""
    pt = np.linspace(0.2, 0.8, V)
    gt = np.full(V, 1.0 / V)
    pc, gc = pt.copy(), gt.copy()
    moving = slice(None) if kind == "unsettled" else slice(1, None, 2)
    if kind != "settled":
        pc[moving] = pt[::-1][moving]
        gc[moving] = 1.5 / V
    return t(0.3 * rs.randn(V, B)), t(pc), t(pt), t(gc), t(gt)


@pytest.mark.parametrize("kind", ["settled", "half", "unsettled"])
@pytest.mark.parametrize("V,B", [(4096, 512), (64, 512), (300, 100), (130, 37)])
def test_mix_bank_is_bit_equal_to_its_plain_version(dev, V, B, kind):
    """Settled voices take their cosine and sine once, the others per
    sample; the three sums in the plain version's order, bit for bit, with
    one chunk and with a partial one, a tail tile and 4-byte copies."""
    rs = np.random.RandomState(7)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(torch.float32)

    args = _mix_rows(rs, t, V, B, kind)
    got = bk.mix_bank(*args, coeff=smoothing_coeff(SR))
    want = bk.mix_bank_plain(*args, coeff=smoothing_coeff(SR))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape == (B,) and torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert float(got[2].abs().max()) > 0.0


@pytest.mark.parametrize("R,B", [(1, 512), (515, 100), (5, 37)])
def test_ws4_bank_over_two_blocks_equals_its_plain_version(dev, R, B):
    """The oversampler state threaded through unpack/pack from one block to
    the next, each side its own: outputs and packed states bit for bit."""
    from libgooey_tpu_torch.ops import oversample

    rs = np.random.RandomState(4)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(torch.float32)

    ovs = {n: oversample.OversamplerState.init((R,), dev) for n in ("kernel", "plain")}
    for _ in range(2):
        x, drive, _ = _ws4_rows(rs, t, R, B)
        outs = {}
        for n, fn in (("kernel", bk.ws4_bank), ("plain", bk.ws4_bank_plain)):
            outs[n] = fn(x, drive, bk.pack_ws4_bank(ovs[n]))
            ovs[n] = bk.unpack_ws4_bank(outs[n][1], ovs[n])
        torch.cuda.synchronize()
        for g, w in zip(outs["kernel"], outs["plain"]):
            assert torch.equal(g, w)
    assert float(outs["kernel"][0].abs().max()) > 0.1


@pytest.mark.parametrize("R,B", [(515, 100), (515, 37), (5, 512)])
def test_affine1_without_floor_equals_the_explicit_floor(dev, R, B):
    """``a = None`` reads no floor array and gives the bits of the explicit
    -3e38 row, with NaN, +-inf and values below the floor in ``c``."""
    rs = np.random.RandomState(2)
    c = rs.randn(R, B).astype(np.float32)
    c[0, B // 2], c[1, B // 3], c[2, ::7], c[3, ::5], c[4, ::3] = (
        np.nan, np.inf, -np.inf, -3.2e38, -3.4e38)
    for value in (np.nan, np.inf, -np.inf, -3.3e38):
        c[5:][rs.rand(R - 5, B) < 0.002] = value
    args = [torch.as_tensor(x, device=dev) for x in (
        rs.uniform(-0.99, 0.99, (R, B)).astype(np.float32), c, rs.randn(R).astype(np.float32))]
    got = bk.affine1_bank(None, *args)
    want = bk.affine1_bank(torch.full((R, B), bk.NO_FLOOR, device=dev), *args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert torch.isinf(got[0][1]).any() and (got[0][2:5] == np.float32(bk.NO_FLOOR)).any()


def test_kit_with_kernels_matches_plain_versions(dev, monkeypatch):
    """The five-family kit at 64 voices a family on the stage path
    (``fused_banks=False``), 2 blocks: kernels vs plain versions, all eight
    launched and the mix once a block."""
    from libgooey_tpu_torch.instruments import bass, hihat2, snare, tom2

    V, B, N = 64, 256, 2
    mods = {"kick": kick, "snare": snare, "hihat2": hihat2, "tom2": tom2, "bass": bass}
    state = {k: m.init_state(V, device=dev) for k, m in mods.items()}
    Vt = V * len(mods)
    state["pan"] = SmootherBank.init(np.linspace(0.2, 0.8, Vt), dev)
    state["gain"] = SmootherBank.init(np.full(Vt, 1.0 / Vt), dev)
    state["master"] = SmootherBank.init(np.float32(0.25), dev)
    rs = np.random.RandomState(2)
    events = {"block_start": (np.arange(N) * B).astype(np.int32)}
    for k in mods:
        events[k + "_off"] = rs.randint(0, 2 * B, (N, V)).astype(np.int32)
        events[k + "_vel"] = rs.uniform(0.3, 1.0, (N, V)).astype(np.float32)
    static = dict(kinds=tuple(mods), sample_rate=SR, block_size=B,
                  smooth_coeff=smoothing_coeff(SR), limiter_threshold=1.0,
                  family_static=(("kick", (("feedback_path", False), ("max_harmonics", 0))),
                                 ("snare", (("max_harmonics", 64),))), fused_banks=False)
    kernels.reset_launch_counts()
    _, got = engine.render_many(state, events, **static)
    counts = kernels.launch_counts()
    assert all(counts[n] > 0 for n in bk.KERNELS) and counts["mix_bank"] == N, counts
    for n in bk.KERNELS:
        monkeypatch.setattr(bk, n, getattr(bk, n + "_plain"))
    _, want = engine.render_many(state, events, **static)
    assert float(got.abs().max()) > 1e-4
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.parametrize("family", ["hihat", "tom", "poly"])
def test_new_families_with_a_route_match_plain_versions(dev, monkeypatch, family):
    """The hihat (its output one-pole: ``affine1_bank``), the tom (its punch:
    ``triangle_additive_bank`` at 128 harmonics) and the poly synth (its
    phases: ``affine1_bank``; its filter: ``svf_bank``) at V = 64 voices
    (the poly synth: 10 synths, 60 lanes) and B = 512, 2 blocks with a routed parameter's trajectory from the
    engine's one-pole scan: kernels vs plain versions within 1e-4."""
    from libgooey_tpu_torch.instruments import hihat, poly, tom
    from libgooey_tpu_torch.ops import scan

    mod, param, kw = {"hihat": (hihat, "decay", {}),
                      "tom": (tom, "frequency", {"max_harmonics": 128}),
                      "poly": (poly, "filter_cutoff", {})}[family]
    V, B, N = 64, 512, 2
    rs = np.random.RandomState(4)
    n_bank = V // poly.NUM_VOICES if family == "poly" else V
    presets = sorted(mod.PRESETS)
    targets = np.stack([mod.PRESETS[presets[v % len(presets)]]().as_array()
                        for v in range(n_bank)])
    lanes = n_bank * poly.NUM_VOICES if family == "poly" else V
    coeff = smoothing_coeff(SR)
    blocks = []
    for blk in range(N):
        off = rs.randint(0, 2 * B, lanes).astype(np.int32)
        vel = rs.uniform(0.3, 1.0, lanes).astype(np.float32)
        lfo = np.clip(0.5 + 0.4 * np.sin(0.01 * (np.arange(B) + blk * B)), 0, 1)
        extra = {}
        if family == "poly":
            extra = dict(trig_freq=rs.uniform(80, 900, lanes).astype(np.float32),
                         release_offset=np.where(rs.rand(lanes) < 0.3, 200, B).astype(np.int32))
        blocks.append((off, vel, np.tile(lfo, (n_bank, 1)).astype(np.float32), extra))

    def render():
        state = mod.init_state(n_bank, targets=targets, device=dev)
        outs = []
        for blk, (off, vel, tgt, extra) in enumerate(blocks):
            traj = scan.onepole(coeff, torch.as_tensor(tgt, device=dev),
                                state.params.current[:, mod.PARAM_INDEX[param]])
            if family == "poly":
                traj = torch.repeat_interleave(traj, poly.NUM_VOICES, dim=0)
            state, out = mod.render_block(state, off, vel, blk * B, sample_rate=SR,
                                          block_size=B, smooth_coeff=coeff,
                                          overrides={param: traj}, **extra, **kw)
            outs.append(out)
        return torch.stack(outs)

    kernels.reset_launch_counts()
    got = render()
    counts = kernels.launch_counts()
    used = {"hihat": ("affine1_bank",), "tom": ("affine1_bank", "triangle_additive_bank"),
            "poly": ("affine1_bank", "svf_bank")}[family]
    assert all(counts[n] >= N for n in used), counts
    for n in bk.KERNELS:
        monkeypatch.setattr(bk, n, getattr(bk, n + "_plain"))
    want = render()
    assert float(got.abs().max()) > 1e-4
    assert float((got - want).abs().max()) <= 1e-4


def test_slice_with_kernels_matches_plain_versions(dev, monkeypatch):
    V, B, N = 256, 256, 2
    state = {
        "kick": kick.init_state(V, kick.KickConfig.tight(), device=dev),
        "pan": SmootherBank.init(np.linspace(0.2, 0.8, V), dev),
        "gain": SmootherBank.init(np.full(V, 1.0 / V), dev),
        "master": SmootherBank.init(np.float32(0.25), dev),
    }
    rs = np.random.RandomState(1)
    events = {"kick_off": rs.randint(0, 2 * B, (N, V)).astype(np.int32),
              "kick_vel": rs.uniform(0.3, 1.0, (N, V)).astype(np.float32),
              "block_start": (np.arange(N) * B).astype(np.int32)}
    static = dict(kinds=("kick",), sample_rate=SR, block_size=B,
                  smooth_coeff=smoothing_coeff(SR), limiter_threshold=1.0,
                  family_static=(("kick", (("feedback_path", False),
                                           ("max_harmonics", 0))),))
    _, got = engine.render_many(state, events, **static)
    for n in bk.KERNELS:
        monkeypatch.setattr(bk, n, getattr(bk, n + "_plain"))
    _, want = engine.render_many(state, events, **static)
    assert float(got.abs().max()) > 1e-4
    assert float((got - want).abs().max()) <= 1e-4


def _bus_cases(dev, B, seed=0):
    """(name, args, kwargs) for each bus wrapper at ``[2, B]``: saturation
    across its bypass gate, a resonant lowpass, a tilt sweep across the
    center, the delay both ways on a tap gathered from a filled ring, the
    compressor's detector on bursts (a bypass span) and its gain stage over
    the knee, the spring on a filled history with decay and damping
    moving, the waveshaper engaged, the feedback waveshaper engaged on the
    detector's envelope."""
    rs = np.random.RandomState(seed)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)

    coeff = smoothing_coeff(SR, 30.0)
    x = t(rs.uniform(-0.9, 0.9, (2, B)))
    sat = saturation.init_state(SR, device=dev)
    ring = ringbuf.Ring(buf=t(rs.uniform(-0.5, 0.5, (2, delay.ring_length(SR)))),
                        pos=torch.tensor(12345, device=dev))
    tap = ringbuf.read_frac(ring, t(np.full((2, B), 0.015 * SR)))
    dl = (x, tap, t([[0.6, 0.8, 4000.0]] * 2), t([[0.3, 0.5, 12000.0]] * 2),
          t(0.1 * rs.randn(2, 2)))
    byp = np.zeros((2, B))
    byp[:, B // 4:B // 3] = 1.0
    env = t(np.abs(rs.uniform(0.0, 1.5, (2, B))))
    comp = compressor.init_state(SR, device=dev)
    mix = np.ones((2, B))
    mix[:, 3 * B // 4:] = 0.0
    dl_s, dr_s = reverb_spring.delay_lengths(SR)
    D = max(dl_s + dr_s)
    damping = np.linspace(0.6, 0.2, B)[None].repeat(2, 0)
    fbgp = np.concatenate([np.zeros((2, 1)), 0.95 * np.linspace(0.3, 0.9, B - 1)[None] ** 0.4
                           * np.ones((2, 1))], axis=-1)
    p2 = 1.0 - damping
    A = damping + p2 * np.prod(reverb_spring.GAINS) * fbgp
    return [
        ("saturation_block", (x, t([[0.6, 0.5, 0.6]] * 2), t([[0.2, 0.9, 0.0]] * 2),
                              bus.pack_saturation(sat.ovs, sat.dc)), dict(coeff=coeff)),
        ("lowpass_block", (x, t(rs.uniform(0.2, 0.9, (2, B))), t(rs.uniform(0.0, 3.3, (2, B))),
                           t(0.1 * rs.randn(2, 2))), {}),
        ("tilt_block", (x, t([[0.25, 0.3]] * 2), t([[0.75, 0.6]] * 2), t(0.05 * rs.randn(2, 2))),
         dict(coeff=coeff, sample_rate=SR)),
        ("delay_block", dl, dict(coeff=coeff, sample_rate=SR, pingpong=False)),
        ("delay_block", dl, dict(coeff=coeff, sample_rate=SR, pingpong=True)),
        ("env_follower_block", (x, t(np.full((2, B), 0.9776)), t(np.full((2, B), 0.99972)),
                                t(byp), t([0.3, 0.0])), {}),
        ("compressor_block", (x, env, t(np.full((2, B), -30.0)), t(np.full((2, B), 8.0)), t(mix),
                              bus.pack_compressor(comp.ovs, comp.dc, comp.gain)), {}),
        ("spring_block", (x, t(A), t(p2), t(fbgp), t(0.3 * rs.randn(12, D)), t([0.05, -0.02]),
                          t(np.full((2, B), 0.4)), t([0.01, -0.03])),
         dict(delays=dl_s + dr_s, gains=reverb_spring.GAINS)),
        ("waveshaper_block", (x, t([[4.0, 0.5], [6.0, 0.8]]), t(0.1 * rs.randn(bk.FBWS_S_IN, 2))),
         {}),
        ("fbws_fast_block", (x, env, t([[4.0, 0.0, 0.25, 1.0], [8.0, 0.0, 0.1, 0.6]]),
                             t(0.1 * rs.randn(bus.COMP_S_IN, 2))), {}),
    ]


@pytest.mark.parametrize("B", [64, 512])
def test_bus_kernels_match_plain_versions(dev, B):
    """Outputs within 1e-5; carried state within 1e-4 of its magnitude
    where that exceeds 1 (the delay's cutoff smoother holds Hz)."""
    for name, args, kw in _bus_cases(dev, B):
        got = getattr(bus, name)(*args, **kw)
        want = getattr(bus, name + "_plain")(*args, **kw)
        torch.cuda.synchronize()
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape and g.device == w.device
            err = float(((g - w).abs() / w.abs().clamp(min=1.0)).max())
            assert err <= (1e-4 if i == len(got) - 1 else 1e-5), f"{name} output {i}: {err}"


def _chain_phases(cases):
    """The bus cases as one run of ten phases: every effect once, the delay
    with ping-pong, the compressor's and the feedback waveshaper's gain
    stages each on the envelope of a detector phase before it, each on the
    signal the one before it left."""
    phases = [bus.Phase(name, args[1:], kw) for name, args, kw in (cases[:3] + cases[4:])]
    env = phases[4]
    phases = phases[:-1] + [env, phases[-1]]
    for i in (5, 9):
        phases[i] = phases[i]._replace(args=(None,) + phases[i].args[1:])
    return phases


@pytest.mark.parametrize("B", [64, 512])
def test_bus_chain_matches_plain_version_and_the_single_kernels(dev, B):
    """One ``bus_chain`` launch: within the bounds above of its plain
    version, and bit for bit what the nine kernels give one after the
    other (the same row functions)."""
    cases = _bus_cases(dev, B)
    x, phases = cases[0][1][0], _chain_phases(cases)
    y, outs = bus.bus_chain(x, phases)
    y_p, outs_p = bus.bus_chain_plain(x, phases)
    y_1, outs_1 = bus.run_phases(x, phases)
    torch.cuda.synchronize()
    assert float((y - y_p).abs().max()) <= 1e-5
    assert torch.equal(y, y_1)
    for ph, got, want, one in zip(phases, outs, outs_p, outs_1):
        for i, (g, w, o) in enumerate(zip(got, want, one)):
            err = float(((g - w).abs() / w.abs().clamp(min=1.0)).max())
            assert err <= (1e-4 if i == len(got) - 1 else 1e-5), f"{ph.name} output {i}: {err}"
            assert torch.equal(g, o), f"{ph.name} output {i}"


def test_each_bus_launch_counts_once(dev):
    kernels.reset_launch_counts()
    cases = _bus_cases(dev, 32)
    for name, args, kw in cases[:4] + cases[5:]:
        getattr(bus, name)(*args, **kw)
        getattr(bus, name + "_plain")(*args, **kw)
    bus.bus_chain(cases[0][1][0], _chain_phases(cases))
    bus.bus_chain_plain(cases[0][1][0], _chain_phases(cases))
    args, kw = _plate_case(dev, 32)
    plate_kernels.plate_block(*args, **kw)
    plate_kernels.plate_block_plain(*args, **kw)
    assert kernels.launch_counts() == {n: int(n in bus.KERNELS or n == "plate_block")
                                       for n in kernels.KERNELS}


def _plate_case(dev, B, seed=0):
    """plate_block's arguments: filled histories, the modulated lags
    sweeping as the size falls 1.0 -> 0.0 across the block."""
    rs = np.random.RandomState(seed)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)

    srs = SR / reverb_plate.DATTORRO_SR
    DIN, DMOD = reverb_plate.in_hist_len(SR), reverb_plate.mod_hist_len(SR)
    size = reverb_plate.size_to_scale(torch.linspace(1.0, 0.0, B)).numpy()
    lfo = np.sin(2 * np.pi * (np.arange(B) * np.array([[0.5], [0.71]]) / SR + [[0.2], [0.7]]))
    mod_off = np.clip(np.array([[672.0], [908.0]]) * srs * size + lfo * 16.0 * srs,
                      1.0, DMOD - 2.0)
    rows = [rs.uniform(-0.5, 0.5, B) for _ in range(6)]
    rows[3] = np.linspace(0.1, 0.6, B)
    return ((*map(t, rows), t(mod_off), t(0.2 * rs.randn(4, DIN)), t(0.2 * rs.randn(2, DMOD)),
             t([0.1, -0.05, 0.02])), dict(sample_rate=SR))


@pytest.mark.parametrize("B", [64, 512])
def test_plate_kernel_matches_plain_version(dev, B):
    """Outputs and damping filters within 1e-5, histories and seeds within
    1e-4."""
    args, kw = _plate_case(dev, B)
    got = plate_kernels.plate_block(*args, **kw)
    want = plate_kernels.plate_block_plain(*args, **kw)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.device == w.device
        assert float((g - w).abs().max()) <= (1e-5 if i < 4 else 1e-4), f"output {i}"


@pytest.mark.parametrize("case", range(6), ids=["512", "100", "33", "lags_to_1", "22050_Hz",
                                                 "96000_Hz"])
def test_plate_kernel_is_bit_equal_to_its_plain_version(dev, case):
    """The chunked plate kernel gives its plain version's outputs, histories
    and seeds bit for bit: whole chunks and tails, modulated lags falling to
    1 (serial chunks), a chunk of 79 at 22,050 Hz and of 256 at 96,000 Hz."""
    import chip_smoke

    if case == 0:
        args, kw = chip_smoke.plate_args(dev, np.random.RandomState(0), 512)
    else:
        _, args, kw = chip_smoke.plate_cases(dev)[case - 1]
    got = plate_kernels.plate_block(*args, **kw)
    want = plate_kernels.plate_block_plain(*args, **kw)
    torch.cuda.synchronize()
    assert _bits_equal(got, want)


def test_kit_with_bus_matches_plain_versions(dev, monkeypatch):
    """The five-family kit at 64 voices a family on the stage path with the
    seven-effect bus (the tilt off center, a 0.015 s delay, the compressor
    over the kit's level, the plate at size 0.0), 2 blocks: kernels vs plain
    versions; the
    bus as one ``bus_chain`` and one ``plate_block`` a block, and with
    ``fuse_bus=False`` each effect's own kernels a block, bit for bit the
    same."""
    from libgooey_tpu_torch.instruments import bass, hihat2, snare, tom2

    V, B, N = 64, 256, 2
    mods = {"kick": kick, "snare": snare, "hihat2": hihat2, "tom2": tom2, "bass": bass}
    state = {k: m.init_state(V, device=dev) for k, m in mods.items()}
    Vt = V * len(mods)
    state["pan"] = SmootherBank.init(np.linspace(0.2, 0.8, Vt), dev)
    state["gain"] = SmootherBank.init(np.full(Vt, 1.0 / Vt), dev)
    state["master"] = SmootherBank.init(np.float32(0.25), dev)
    fx = ("saturation", "lowpass", "tilt", "delay", "compressor", "spring", "plate")
    targets = dict(engine.FX_DEFAULT_TARGETS, tilt=[0.3, 0.4], delay=[0.015, 0.5, 0.4, 6000.0],
                   compressor=[-60.0, 8.0, 1.0, 50.0, 1.0],
                   plate=[0.5, 0.3, 0.5, 0.0, 1.0, 0.0])
    for name in fx:
        state["fx_" + name] = engine.FX_MODULES[name].init_state(SR, device=dev)
    rs = np.random.RandomState(3)
    events = {"block_start": (np.arange(N) * B).astype(np.int32)}
    for k in mods:
        events[k + "_off"] = rs.randint(0, 2 * B, (N, V)).astype(np.int32)
        events[k + "_vel"] = rs.uniform(0.3, 1.0, (N, V)).astype(np.float32)
    for name in fx:
        events["fx_" + name] = np.tile(np.float32(targets[name]), (N, 1))
    static = dict(kinds=tuple(mods), sample_rate=SR, block_size=B,
                  smooth_coeff=smoothing_coeff(SR), limiter_threshold=1.0,
                  family_static=(("kick", (("feedback_path", False), ("max_harmonics", 0))),
                                 ("snare", (("max_harmonics", 64),))), fx_order=fx,
                  fused_banks=False)
    singles = ("saturation_block", "lowpass_block", "tilt_block", "delay_block",
               "env_follower_block", "compressor_block", "spring_block")
    kernels.reset_launch_counts()
    _, got = engine.render_many(state, events, **static)
    counts = kernels.launch_counts()
    assert all(counts[n] > 0 for n in bk.KERNELS), counts
    assert counts["bus_chain"] == N and counts["plate_block"] == N, counts
    assert all(counts[n] == 0 for n in singles), counts
    kernels.reset_launch_counts()
    _, got_1 = engine.render_many(state, events, fuse_bus=False, **static)
    counts = kernels.launch_counts()
    assert counts["bus_chain"] == 0 and all(counts[n] == N for n in singles), counts
    assert torch.equal(got, got_1)
    for n in kernels.KERNELS:
        mod = kernels.module_of(n)
        monkeypatch.setattr(mod, n, getattr(mod, n + "_plain"))
    _, want = engine.render_many(state, events, **static)
    assert float(got.abs().max()) > 1e-4
    assert float((got - want).abs().max()) <= 1e-4


def _kit_state(dev, per_family, seed):
    """A kit of random parameter targets with the smoothers still moving
    (the snare's Chamberlin kept well off its unstable corner: at 512
    samples a block tests/test_pallas_voice.py's clamps still let it ring
    up to inf)."""
    rs = np.random.RandomState(seed)
    state = {}
    for kind, nv in per_family.items():
        mod = engine.FAMILIES[kind]
        if kind == "tom2":
            state[kind] = mod.init_state(nv, device=dev)
            continue
        tg = rs.uniform(0, 1, (nv, mod.NUM_PARAMS)).astype(np.float32)
        cur = np.clip(tg + 0.2 * rs.randn(*tg.shape), 0, 1).astype(np.float32)
        if kind == "snare":
            for p, hi in (("filter_cutoff", 0.5), ("filter_resonance", 0.3)):
                i = mod.PARAM_INDEX[p]
                tg[:, i] = np.minimum(tg[:, i], hi)
                cur[:, i] = np.minimum(cur[:, i], hi)
        st = mod.init_state(nv, targets=tg, device=dev)
        state[kind] = st._replace(params=SmootherBank(
            current=torch.as_tensor(cur, device=dev), target=st.params.target))
    return state, rs


@pytest.mark.parametrize("per_family,B", [({"kick": 5, "snare": 3, "hihat2": 40, "tom2": 2,
                                            "bass": 33}, 64),
                                           ({"kick": 16, "snare": 16, "hihat2": 16, "tom2": 8,
                                             "bass": 8}, 512)])
def test_kit_kernels_match_plain_versions(dev, per_family, B):
    """kit_sources and kit_drive against their plain versions after 3 blocks
    of staggered triggers: outputs within 1e-5, carried state within 1e-4
    of its magnitude where that exceeds 1."""
    from libgooey_tpu_torch.ops import voice
    from libgooey_tpu_torch.ops import voice_kernels as vk

    state, rs = _kit_state(dev, per_family, 4)
    kw = dict(kinds=tuple(per_family), sample_rate=SR, block_size=B,
              smooth_coeff=smoothing_coeff(SR), kick_max_harmonics=64, snare_max_harmonics=64)

    def events():
        return ({k: np.where(rs.rand(v) < 0.5, rs.randint(0, B, v), B).astype(np.int32)
                 for k, v in per_family.items()},
                {k: rs.uniform(0.3, 1.0, v).astype(np.float32) for k, v in per_family.items()})

    for b in range(3):
        offs, vels = events()
        res = voice.kit_render_fused(state, offs, vels, np.int32(b * B), **kw)
        state = {k: r[0] for k, r in res.items()}
    offs, vels = events()
    blk = voice._Block(dev, np.int32(3 * B), B, SR, kw["smooth_coeff"])
    off = {k: blk.ints(offs[k]) for k in per_family}
    vel = {k: blk.floats(vels[k]) for k in per_family}
    pa = [voice._kick_phase_a(state["kick"], off["kick"], vel["kick"], blk, 64),
          voice._snare_phase_a(state["snare"], off["snare"], vel["snare"], blk, 64),
          voice._hihat2_phase_a(state["hihat2"], off["hihat2"], vel["hihat2"], blk),
          voice._tom2_phase_a(state["tom2"], off["tom2"], blk, True),
          voice._bass_phase_a(state["bass"], off["bass"], vel["bass"], None, blk)]
    got_a, want_a = vk.kit_sources(pa), vk.kit_sources_plain(pa)
    pb = [voice._kick_phase_m(state["kick"], want_a[0], blk)[0],
          voice._snare_phase_m(state["snare"], off["snare"], vel["snare"], want_a[1], blk)[0]]
    got_b, want_b = vk.kit_drive(pb), vk.kit_drive_plain(pb)
    torch.cuda.synchronize()
    for phases, got, want in ((pa, got_a, want_a), (pb, got_b, want_b)):
        for ph, g_all, w_all in zip(phases, got, want):
            for i, (g, w) in enumerate(zip(g_all, w_all)):
                assert g.shape == w.shape and g.dtype == w.dtype, (ph.name, i)
                if g.dtype == torch.int32:
                    assert torch.equal(g, w), (ph.name, i)
                    continue
                err = float(((g - w).abs() / w.abs().clamp(min=1.0)).max())
                tol = 1e-5 if w.shape[-1] == B and w.shape[0] == ph.args[0].shape[0] else 1e-4
                assert err <= tol, f"{ph.name} output {i}: {err}"


def test_product_block_with_kernels_matches_plain_versions(dev, monkeypatch):
    """The product block at a small width: kick, snare, hihat2 4 voices,
    tom2 and bass 3, through the kit kernels (one kit_sources and one
    kit_drive a block), then the nine-entry chain with both waveshapers
    engaged (one ten-phase bus_chain and one plate_block a block), 3
    blocks: kernels vs plain versions."""
    from libgooey_tpu_torch.mixer import chain

    per_family = {"kick": 4, "snare": 4, "hihat2": 4, "tom2": 3, "bass": 3}
    N, B = 3, 256
    Vt = sum(per_family.values())
    ids = (0, 1, 2, 3, 4, 6, 7, 8, 9)

    def run():
        state = {k: engine.FAMILIES[k].init_state(v, device=dev) for k, v in per_family.items()}
        state["pan"] = SmootherBank.init(np.full(Vt, 0.5), dev)
        state["gain"] = SmootherBank.init(np.full(Vt, 1.0 / Vt), dev)
        state["master"] = SmootherBank.init(np.float32(0.25), dev)
        fx = chain.EffectChain(SR, 120.0, device=dev)
        for eid in ids:
            fx.add(eid)
        fx.set_param(6, 0, 4.0)
        fx.set_param(6, 1, 0.5)
        fx.set_param(7, 0, 4.0)
        fx.set_param(7, 3, 1.0)
        rs = np.random.RandomState(5)
        outs = []
        for b in range(N):
            ev = {"block_start": np.int32(b * B)}
            for k, v in per_family.items():
                ev[k + "_off"] = rs.randint(0, 2 * B, v).astype(np.int32)
                ev[k + "_vel"] = rs.uniform(0.5, 1.0, v).astype(np.float32)
            state, stereo, _ = engine._render_all(
                state, ev, kinds=tuple(per_family), sample_rate=SR, block_size=B,
                smooth_coeff=smoothing_coeff(SR), limiter_threshold=1.0,
                family_static=(("kick", (("feedback_path", False), ("max_harmonics", 64))),
                               ("snare", (("max_harmonics", 64),))))
            fx.states, y = chain.process_chain(fx.states, stereo, fx.targets_list(),
                                               fx.static_key(), sample_rate=SR)
            outs.append(y)
        return torch.stack(outs)

    kernels.reset_launch_counts()
    got = run()
    counts = kernels.launch_counts()
    for n in ("kit_sources", "kit_drive", "bus_chain", "plate_block"):
        assert counts[n] == N, counts
    for n in kernels.KERNELS:
        mod = kernels.module_of(n)
        monkeypatch.setattr(mod, n, getattr(mod, n + "_plain"))
    want = run()
    assert float(got.abs().max()) > 1e-3
    assert float((got - want).abs().max()) <= 1e-4


def _grain_case(dev, G, L, B, seed=0):
    """grain_read_cubic arguments: a white-noise source, starts across and
    beyond it, steps ±[0.5, 2], lanes at |step| = 8, never-spawned lanes."""
    rs = np.random.RandomState(seed)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

    p0 = rs.uniform(-300.0, L + 300.0, G)
    step = rs.uniform(0.5, 2.0, G) * rs.choice([-1.0, 1.0], G)
    step[::9] = np.sign(step[::9]) * 8.0
    age0 = rs.randint(-3 * B, 60000, G)
    age0[::13] = 2**30
    return t(0.3 * rs.randn(L)), t(p0), t(step), t(age0, torch.int32)


def _sampler_case(dev, V, F, B, seed=0):
    """sampler_read_linear arguments: fractional slot ends, bases spread
    over the arena (some past its end), mixed starts, increments 0.25-3."""
    rs = np.random.RandomState(seed)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

    frames = rs.uniform(64.0, F / 4, V) + rs.choice([0.0, 0.25, 0.5], V)
    base = rs.randint(0, F, V)
    return (t(0.3 * rs.randn(F, 2)), t(base, torch.int32), t(frames),
            t(rs.randint(-20000, 2 * B, V), torch.int32), t(rs.uniform(0.25, 3.0, V)))


@pytest.mark.parametrize("G,B", [(37, 64), (4000, 512)])
def test_grain_read_matches_plain_version(dev, G, B):
    from libgooey_tpu_torch.ops import grain_kernels as gk

    buf, p0, step, age0 = _grain_case(dev, G, 1 << 15, B)
    for kw in (dict(age0=age0), {}):
        got = gk.grain_read_cubic(buf, p0, step, B=B, **kw)
        want = gk.grain_read_cubic_plain(buf, p0, step, B=B, **kw)
        torch.cuda.synchronize()
        assert got.shape == want.shape == (G, B)
        assert float((got - want).abs().max()) <= 1e-6


@pytest.mark.parametrize("V,B", [(5, 64), (128, 512)])
def test_sampler_read_matches_plain_version(dev, V, B):
    from libgooey_tpu_torch.ops import grain_kernels as gk

    args = _sampler_case(dev, V, 1 << 15, B)
    got = gk.sampler_read_linear(*args, 3 * B, B=B)
    want = gk.sampler_read_linear_plain(*args, 3 * B, B=B)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (V, B, 2)
    assert float((got - want).abs().max()) <= 1e-6


@pytest.mark.parametrize("case", range(5))
def test_sampler_read_is_bit_equal_at_its_tails(dev, case):
    """sampler_read_linear (a block a voice tile, pairs of frames a thread)
    gives its plain version bit for bit at chip_smoke's tails: one voice,
    130 voices of 512, 100 and 33 samples (float2 stores at the odd B), the
    hold plateau, negative and non-finite increments, ages before the start,
    bases at the arena's end, ages wrapping past 2^31."""
    import chip_smoke
    from libgooey_tpu_torch.ops import grain_kernels as gk

    cases = chip_smoke.sampler_tail_cases(dev)
    assert len(cases) == 5
    label, args, kw = cases[case]
    got = gk.sampler_read_linear(*args, **kw)
    want = gk.sampler_read_linear_plain(*args, **kw)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (args[1].shape[0], kw["B"], 2), label
    assert _bits_equal(got, want), label


def test_each_grain_launch_counts_once(dev):
    from libgooey_tpu_torch.ops import grain_kernels as gk

    kernels.reset_launch_counts()
    buf, p0, step, age0 = _grain_case(dev, 16, 4096, 32)
    gk.grain_read_cubic(buf, p0, step, B=32, age0=age0)
    gk.grain_read_cubic_plain(buf, p0, step, B=32, age0=age0)
    args = _sampler_case(dev, 8, 4096, 32)
    gk.sampler_read_linear(*args, 0, B=32)
    gk.sampler_read_linear_plain(*args, 0, B=32)
    assert kernels.launch_counts() == {n: int(n in gk.KERNELS) for n in kernels.KERNELS}


def test_granulator_and_sampler_with_kernels_match_plain_versions(dev, monkeypatch):
    """The 4k slice's blocks at 240 grain lanes and 16 voices, the drive
    engaged, grains spawned and stolen by a host cloud, 3 blocks: kernels
    vs plain versions within 1e-4; one grain read, one sampler read, one
    ws4_bank and one affine1_bank a block."""
    from libgooey_tpu_torch.instruments import granulator as gran
    from libgooey_tpu_torch.instruments import sampler as samp
    from libgooey_tpu_torch.ops import grain_kernels as gk

    B, N = 256, 3
    rs = np.random.RandomState(7)
    buf = (0.3 * rs.randn(1 << 15)).astype(np.float32)
    arena = torch.as_tensor(0.3 * rs.randn(1 << 15, 2), dtype=torch.float32, device=dev)

    def run():
        gs = gran.init_state(buf, SR, gran.GranulatorConfig(drive=0.5), device=dev)
        lanes = 3 * gran.TOTAL
        gs = gs._replace(**{f: getattr(gs, f).repeat(3) for f in
                            gran._GRAIN_FIELDS + ("rel_start", "rel_total")})
        host = gran.GranulatorHost(SR, buf, SR, gran.GranulatorConfig(density=1.0,
                                                                      random_timing=0.5))
        host.trigger(0.0)
        ss = samp.init_state(1 << 15, device=dev)
        ss = ss._replace(arena=arena,
                         **{f: getattr(ss, f)[:16] for f in samp.SamplerState._fields[1:]})
        ev = samp.StartEvents.empty()
        ev.voice[:16] = np.arange(16)
        ev.offset[:16] = np.arange(16) * 13
        ev.base[:16] = np.arange(16) * 1500
        ev.frames[:16] = 1000.5
        ev.increment[:16] = np.linspace(0.5, 2.0, 16)
        ev.velocity[:16] = 0.7
        outs = []
        for i in range(N):
            gs, g = gran.render_block(gs, host.collect_events(i * B, B), i * B, sample_rate=SR,
                                      block_size=B, smooth_coeff=smoothing_coeff(SR))
            ss, s = samp.render_block(ss, ev if i == 0 else samp.StartEvents.empty(), i * B,
                                      sample_rate=SR, block_size=B)
            outs.append(g + s[0])
        assert lanes == gs.src_pos.shape[0]
        return torch.stack(outs)

    kernels.reset_launch_counts()
    got = run()
    counts = kernels.launch_counts()
    for n in ("grain_read_cubic", "sampler_read_linear", "ws4_bank", "affine1_bank"):
        assert counts[n] == N, counts
    for n in kernels.KERNELS:
        mod = kernels.module_of(n)
        monkeypatch.setattr(mod, n, getattr(mod, n + "_plain"))
    want = run()
    assert float(got.abs().max()) > 1e-3
    assert float((got - want).abs().max()) <= 1e-4
    assert gk.KERNELS == ("grain_read_cubic", "sampler_read_linear")


def _bits_equal(got, want):
    """Every tensor of two nested outputs equal bit for bit (floats by their
    int32 view, so NaNs and signed zeros count)."""
    if isinstance(got, (tuple, list)):
        return len(got) == len(want) and all(_bits_equal(g, w) for g, w in zip(got, want))
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    return got.shape == want.shape and bool(torch.equal(got, want))


_ODD_KIT = {"kick": 5, "snare": 3, "hihat2": 7, "tom2": 1, "bass": 2}
_PRODUCT_KIT = {"kick": 16, "snare": 16, "hihat2": 16, "tom2": 8, "bass": 8}


@pytest.mark.parametrize("B", [512, 100, 37])
@pytest.mark.parametrize("kit", [dict.fromkeys(_ODD_KIT, 1), _ODD_KIT, _PRODUCT_KIT,
                                 dict.fromkeys(_ODD_KIT, 128)],
                         ids=["one_a_family", "odd", "product", "128_a_family"])
def test_kit_sources_is_bit_equal_to_its_plain_version(dev, kit, B):
    """kit_sources (a block per voice row, 128-sample tiles) gives its plain
    version's outputs and carried state bit for bit, with B not a multiple
    of the tile, a family of one voice and the kit path's 128."""
    import chip_smoke

    from libgooey_tpu_torch.ops import voice_kernels as vk

    phases, _ = chip_smoke.kit_phases(dev, kit, B)
    got, want = vk.kit_sources(phases), vk.kit_sources_plain(phases)
    torch.cuda.synchronize()
    for ph, g, w in zip(phases, got, want):
        assert _bits_equal(g, w), ph.name


@pytest.mark.parametrize("B", [512, 100, 37])
@pytest.mark.parametrize("kit", [dict.fromkeys(_ODD_KIT, 1), _ODD_KIT, _PRODUCT_KIT,
                                 dict.fromkeys(_ODD_KIT, 128)],
                         ids=["one_a_family", "odd", "product", "128_a_family"])
def test_kit_drive_is_bit_equal_to_its_plain_version(dev, kit, B):
    """kit_drive (a block per voice row, 32-sample chunks pipelined over
    warps: the up-walk, the shaper, the down-walk with the kick's DC blocker
    and feedback filter, the finish) gives its plain version's outputs and
    carried state bit for bit, with B not a multiple of the chunk, a family
    of one voice and the kit path's 128."""
    import chip_smoke

    from libgooey_tpu_torch.ops import voice_kernels as vk

    _, phases = chip_smoke.kit_phases(dev, kit, B)
    got, want = vk.kit_drive(phases), vk.kit_drive_plain(phases)
    torch.cuda.synchronize()
    for ph, g, w in zip(phases, got, want):
        assert _bits_equal(g, w), ph.name
    assert float(got[0][0].abs().max()) > 0.0


@pytest.mark.parametrize("B", [512, 100, 33])
@pytest.mark.parametrize("run", range(6),
                         ids=["7_phases", "4_phases", "10_phases", "1_phase", "12_phases",
                              "9_phases_two_delays_spring_last"])
def test_bus_chain_is_bit_equal_to_its_plain_version_and_its_kernels(dev, run, B):
    """bus_chain (phases pipelined over warps in 32-sample chunks, the 4x
    phases split over their warp) gives its plain version and its phases'
    own kernels in turn bit for bit, with B not a multiple of the chunk,
    one phase and twelve, two delays, a delay after the spring and the
    spring last."""
    import chip_smoke

    _, runs = chip_smoke.bus_cases(dev, np.random.RandomState(B), B)
    x, phases = list(runs.values())[run]
    got = bus.bus_chain(x, phases)
    want = bus.bus_chain_plain(x, phases)
    turn = bus.run_phases(x, phases)
    torch.cuda.synchronize()
    assert _bits_equal(got, want)
    assert _bits_equal(got, turn)


@pytest.mark.parametrize("B", [512, 100, 33])
@pytest.mark.parametrize("name", ["saturation_block", "compressor_block", "waveshaper_block",
                                  "fbws_fast_block"])
def test_lone_4x_kernels_are_bit_equal_to_their_plain_versions(dev, name, B):
    """saturation_block, compressor_block, waveshaper_block and
    fbws_fast_block (their four walks pipelined over warps) give their
    plain versions bit for bit, with B not a multiple of the chunk and the
    bypass gates crossed inside chunks (the compressor's gain through 0.99
    too; the waveshapers bypassed by mix and by drive, engaged, with +-inf
    samples, the feedback waveshaper's envelope under its floor, its
    drive_norm clip and its filter's flush); a bus_chain run of each, with
    the compressor's detector before it, gives the kernels in turn."""
    import chip_smoke

    cases = [c for c in chip_smoke.lone_edge_cases(dev, B) if c[0] == name]
    assert len(cases) == (1 if name in ("saturation_block", "compressor_block") else 3)
    for case, label, args, kw in cases:
        got = getattr(bus, name)(*args, **kw)
        want = getattr(bus, name + "_plain")(*args, **kw)
        torch.cuda.synchronize()
        assert _bits_equal(got, want), label
        assert float(got[0].nan_to_num().abs().max()) > 0.1
        phases = [bus.Phase(name, args[1:], kw)]
        if name == "compressor_block":
            zeros = torch.zeros_like(args[0])
            phases = [bus.Phase("env_follower_block", (zeros + 0.9776, zeros + 0.99972, zeros,
                                                       torch.zeros(2, device=dev)), {}),
                      bus.Phase(name, (None,) + tuple(args[2:]), kw)]
        run = bus.bus_chain(args[0], phases)
        turn = bus.run_phases(args[0], phases)
        torch.cuda.synchronize()
        assert _bits_equal(run, turn), label


@pytest.mark.parametrize("B", [512, 100, 33])
@pytest.mark.parametrize("name", ["lowpass_block", "delay_block", "tilt_block"])
def test_lone_walk_kernels_are_bit_equal_to_their_plain_versions(dev, name, B):
    """lowpass_block, delay_block and tilt_block (each channel's walk on a
    warp of its own, on values computed ahead) give their plain versions
    bit for bit, with B not a multiple of the chunk: the bus cases, the
    lowpass's feedback across 1, its stages flushed under 1e-15 inside a
    chunk and +-inf in x, the delay's smoothers settling inside chunks, its
    writes flushed, a NaN tap (a NaN agreeing by its bits), both ping-pong
    settings and an unaligned tap (4-byte copies); the tilt's knob through
    the center inside a chunk, a passthrough span inside the block, Q at
    its top, +-inf in x and x unaligned; a bus_chain run of each gives the
    kernel."""
    import chip_smoke

    singles, _ = chip_smoke.bus_cases(dev, np.random.RandomState(B), B)
    cases = [c for c in chip_smoke.lone_edge_cases(dev, B) if c[0] == name]
    cases += [(n, label, a, kw) for n, label, a, kw, _ in singles if n == name]
    assert len(cases) == {"lowpass_block": 3, "delay_block": 5, "tilt_block": 5}[name]
    for case, label, args, kw in cases:
        got = getattr(bus, name)(*args, **kw)
        want = getattr(bus, name + "_plain")(*args, **kw)
        torch.cuda.synchronize()
        assert _bits_equal(got, want), label
        assert float(got[0].abs().max()) > 0.1, label
        run = bus.bus_chain(args[0], [bus.Phase(name, args[1:], kw)])
        turn = bus.run_phases(args[0], [bus.Phase(name, args[1:], kw)])
        torch.cuda.synchronize()
        assert _bits_equal(run, turn), label


@pytest.mark.parametrize("case", ["512", "100", "33", "22050_Hz", "96000_Hz", "unaligned",
                                  "parts_of_3_samples"])
def test_env_and_spring_kernels_are_bit_equal_to_their_plain_versions(dev, case):
    """env_follower_block (its walks on warps of their own, values computed
    ahead) and spring_block (parts of the shortest lag, its walk on warps of
    their own) give their plain versions bit for bit: at 512, 100 and 33
    samples (the bus cases', and the detector's bypass span ending inside
    chunks), the spring at 22,050 and 96,000 Hz, with its history
    unaligned (4-byte fill) and with its shortest lag cut to 3 (parts of 3
    samples); a bus_chain run of the detector,
    the compressor and the spring gives the kernels in turn."""
    import chip_smoke

    names = ("env_follower_block", "spring_block")
    if case.isdigit():
        B = int(case)
        lone = {c[0]: c for c in chip_smoke.lone_edge_cases(dev, B)}
        singles, _ = chip_smoke.bus_cases(dev, np.random.RandomState(B), B)
        cases = [lone[n] for n in names]
        cases += [(n, label, a, kw) for n, label, a, kw, _ in singles if n in names]
    else:
        cases = [("spring_block", label, a, kw) for label, a, kw in chip_smoke.spring_cases(dev)
                 if label.endswith(case.replace("_", " "))]
    assert len(cases) == (4 if case.isdigit() else 1)
    for name, label, args, kw in cases:
        got = getattr(bus, name)(*args, **kw)
        want = getattr(bus, name + "_plain")(*args, **kw)
        torch.cuda.synchronize()
        assert _bits_equal(got, want), label
        assert float(got[0].abs().max()) > 0.1, label
    if case.isdigit():
        (_, _, env, _), (_, _, comp, _), (_, _, spring, spring_kw) = (
            lone[n] for n in ("env_follower_block", "compressor_block", "spring_block"))
        phases = [bus.Phase("env_follower_block", env[1:], {}),
                  bus.Phase("compressor_block", (None,) + tuple(comp[2:]), {}),
                  bus.Phase("spring_block", spring[1:], spring_kw)]
        run = bus.bus_chain(env[0], phases)
        turn = bus.run_phases(env[0], phases)
        torch.cuda.synchronize()
        assert _bits_equal(run, turn)


@pytest.mark.parametrize("case", range(10),
                         ids=["drawn_apart", "snare_traffic"]
                         + [f"edge_{b}_{h}" for b in (512, 100) for h in (64, 0, 1, 192)])
def test_triangle_is_bit_equal_to_its_plain_version(dev, case):
    """The redesigned triangle (the untapered gains from a table, the taper
    test against T, the walk stopped at the first inactive term) gives its
    plain version bit for bit: 1,024 voices with every sample's frequency
    drawn apart, the snare's own traffic (the kit snare bank's launch at
    ``chip_smoke.SNARE_BLOCK``), and the edge frequencies (NaN, +-inf,
    +-0, negative, subnormal, T/h, nyquist/h, the max_h steps) at 0, 1, 64
    and 192 harmonics in rows of 512 and 100."""
    import chip_smoke

    kw = dict(sample_rate=SR, max_harmonics=64)
    if case == 0:
        rs = np.random.RandomState(8)
        args = (torch.as_tensor(rs.randint(0, 2 * int(SR), (1024, 1)) + np.arange(512)[None, :],
                                dtype=torch.float32, device=dev),
                torch.as_tensor(rs.uniform(40.0, 2000.0, (1024, 512)), dtype=torch.float32,
                                device=dev))
    elif case == 1:
        args = chip_smoke.snare_triangle_args(dev)
    else:
        _, args, kw = chip_smoke.triangle_tail_cases(dev)[case - 2]
    got = bk.triangle_additive_bank(*args, **kw)
    want = bk.triangle_additive_bank_plain(*args, **kw)
    torch.cuda.synchronize()
    assert _bits_equal(got, want)


@pytest.mark.parametrize("case", range(9),
                         ids=["4000_ages", "4000_age_n", "one_grain", "three_100_a", "three_100_b",
                              "three_33_a", "three_33_b", "37_L1", "37_L3"])
def test_grain_read_is_bit_equal_to_its_plain_version(dev, case):
    """The redesigned grain read (rows on the grid's x, 512-sample tiles on
    its y, four samples a thread) gives its plain version bit for bit at
    the 4k bench's 4,000 grains with ages and without, one grain, three of
    100 and 33 samples on a 4-sample source with steps of +-8.7 and
    infinite ones, and 37 of 99 on one and on three samples."""
    import chip_smoke

    from libgooey_tpu_torch.ops import grain_kernels as gk

    if case < 2:
        buf, p0, step, age0 = _grain_case(dev, 4000, 1 << 15, 512)
        args, kw = (buf, p0, step), dict(B=512, age0=age0 if case == 0 else None)
    else:
        _, args, kw = chip_smoke.grain_tail_cases(dev)[case - 2]
    got = gk.grain_read_cubic(*args, **kw)
    want = gk.grain_read_cubic_plain(*args, **kw)
    torch.cuda.synchronize()
    assert _bits_equal(got, want)


@pytest.mark.parametrize("shape", [(260, 882), (124, 882), (12, 1764)],
                         ids=["coarse_4x65", "fine_4x31", "grains_4x3"])
def test_grain_read_is_bit_equal_at_the_wsola_shapes(dev, shape):
    """grain_read_cubic at the streamed WSOLA loop's reads at 44.1 kHz (four
    channels' coarse and fine candidates of one hop, their grain rows of
    win_n) from a flattened union of 4 x 3 x U samples, each channel's starts
    inside its own third of rows, bit for bit against its plain version."""
    from libgooey_tpu_torch.ops import grain_kernels as gk

    G, B = shape
    C, U = 4, 2900
    rs = np.random.RandomState(G)
    union = torch.as_tensor(0.3 * rs.randn(C * 3 * U), dtype=torch.float32, device=dev)
    step = np.repeat(rs.uniform(0.9, 1.1, C), G // C)
    chan = np.repeat(np.arange(C) * 3 * U, G // C)
    p0 = chan + rs.uniform(4.0, U - 1.1 * B - 4.0, G)
    args = (union, torch.as_tensor(p0, dtype=torch.float32, device=dev),
            torch.as_tensor(step, dtype=torch.float32, device=dev))
    got = gk.grain_read_cubic(*args, B=B)
    want = gk.grain_read_cubic_plain(*args, B=B)
    torch.cuda.synchronize()
    assert got.shape == (G, B) and _bits_equal(got, want)


def test_streamed_loops_match_plain_versions(dev, monkeypatch):
    """chip_smoke's four 8 s loops at warp 1.5 through the streamed hop loop,
    render_blocks(8): every channel streamed, three grain reads a hop, the
    render within 1e-4 of a copy's render on the plain versions."""
    import copy

    import chip_smoke
    from libgooey_tpu_torch.mixer import wsola

    monkeypatch.setattr(wsola, "USE_DEVICE_SEARCH", True)
    m = chip_smoke.loop_mixer(dev, chip_smoke.loop_buffers())
    twin = copy.deepcopy(m)
    hops = chip_smoke.stream_hops_due(m, 8)
    kernels.reset_launch_counts()
    got = m.render_blocks(8)
    counts = kernels.launch_counts()
    assert m.streamed_channels == 4 and counts["grain_read_cubic"] == 3 * hops, counts
    for n in kernels.KERNELS:
        mod = kernels.module_of(n)
        monkeypatch.setattr(mod, n, getattr(mod, n + "_plain"))
    want = twin.render_blocks(8)
    assert got.shape == (2, 8 * 512) and float(got.abs().max()) > 1e-3
    assert float((got - want).abs().max()) <= 1e-4


def _gooey_session(g):
    """Four sequenced strips, saturation and delay, a chord on the poly."""
    from libgooey_tpu_torch.mixer import chain as chain_mod

    for ch in range(4):
        g.sequencers[ch].set_pattern_string("x.x.x.x.x.x.x.x.")
        g.sequencers[ch].start()
    for eid in (chain_mod.EFFECT_SATURATION, chain_mod.EFFECT_DELAY):
        g.set_effect_enabled(eid, True)
    g.perf_chord_on(0, 0, 0, 0, 1, 4, 0.8)
    return g


def test_gooey_engine_lands_on_the_card(dev):
    from libgooey_tpu_torch.gooey import GooeyEngine

    g = GooeyEngine()
    assert g.device.type == "cuda"
    assert g.engine.device.type == "cuda" and g.master.current.device.type == "cuda"
    assert g.gran_state.buffer.device.type == "cuda"
    g.render(512)
    assert all(getattr(v.params, "current", v.params).device.type == "cuda"
               for v in g.engine._state.values() if hasattr(v, "params"))


def test_gooey_span_equals_the_per_block_path(dev):
    """render(16 blocks) through the span against the per-block path of a
    second engine, on the card, within 1e-4; the span's block loop under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host read and no
    blocking copy inside it)."""
    from libgooey_tpu_torch import gooey
    from libgooey_tpu_torch.gooey import GooeyEngine

    ga, gb = _gooey_session(GooeyEngine()), _gooey_session(GooeyEngine())
    gb.span_rendering = False
    ga.render(2 * 512)
    gb.render(2 * 512)
    real = gooey._span_render

    def strict(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    gooey._span_render = strict
    try:
        a = ga.render(16 * 512)
    finally:
        gooey._span_render = real
    b = gb.render(16 * 512)
    assert ga.error is None, ga.error
    assert gb.error is None, gb.error
    assert np.abs(a).max() > 1e-3
    assert float(np.abs(a - b).max()) <= 1e-4


def test_gooey_bounce_is_float32_interleaved(dev):
    from libgooey_tpu_torch.gooey import GooeyEngine

    g = _gooey_session(GooeyEngine())
    inter = g.bounce_to_buffer(3 * 512 + 100)
    assert isinstance(inter, np.ndarray) and inter.dtype == np.float32
    assert inter.shape == ((3 * 512 + 100) * 2,)
    assert np.all(np.isfinite(inter)) and np.abs(inter).max() > 1e-3


def test_capi_session_matches_plain_versions(dev, monkeypatch):
    """chip_smoke's C-API session (integer ids only) on the card: two calls
    of ``engine_render(h, 512)`` within 1e-4 of a copy's calls on the plain
    versions; contiguous float32 interleaved audio."""
    import copy

    import chip_smoke
    from libgooey_tpu_torch import capi

    monkeypatch.delenv(capi.DEVICE_ENV, raising=False)
    h = chip_smoke.capi_session(capi)
    assert capi._e(h).device.type == "cuda"
    twin = copy.deepcopy(capi._e(h))
    got = [capi.engine_render(h, 512) for _ in range(2)]
    for n in kernels.KERNELS:
        mod = kernels.module_of(n)
        monkeypatch.setattr(mod, n, getattr(mod, n + "_plain"))
    want = [twin.render(512) for _ in range(2)]
    assert capi.engine_has_error(h) == 0, capi.engine_last_error(h)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.flags["C_CONTIGUOUS"] and g.shape == (1024,)
        assert float(np.abs(g - w).max()) <= 1e-4
    assert max(float(np.abs(g).max()) for g in got) > 1e-3
    capi.engine_free(h)


def test_capi_shim_c_smoke_on_the_card(dev):
    """The port's C shim built on the card's machine and its C smoke test
    run with no device request: the engine on the card."""
    import os
    import subprocess

    from libgooey_tpu_torch.native import build as shim_build

    missing = shim_build.toolchain_missing()
    if missing is not None:
        pytest.skip(f"the card's machine lacks {missing}")
    res = subprocess.run(["python3-config", "--embed", "--ldflags"], capture_output=True)
    if res.returncode != 0:
        pytest.skip("the card's python3-config has no --embed")
    out = shim_build.build()
    env = {k: v for k, v in os.environ.items() if k != "LIBGOOEY_TPU_TORCH_DEVICE"}
    proc = subprocess.run([str(out / shim_build.SMOKE_NAME), str(shim_build.REPO)],
                          env=shim_build.embed_env(env), capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK"), proc.stdout
