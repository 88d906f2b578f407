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
from libgooey_tpu_torch.engine import engine
from libgooey_tpu_torch.instruments import kick
from libgooey_tpu_torch.ops import bank_kernels as bk

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
    ]


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
    bk.reset_launch_counts()
    for name, args, kw in _cases(dev, 64, 32):
        getattr(bk, name)(*args, **kw)
        getattr(bk, name + "_plain")(*args, **kw)
    assert bk.launch_counts() == {n: 1 for n in bk.KERNELS}


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


def test_kit_with_kernels_matches_plain_versions(dev, monkeypatch):
    """The five-family kit at 64 voices a family, 2 blocks: kernels vs
    plain versions, all eight launched."""
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
                                 ("snare", (("max_harmonics", 64),))))
    bk.reset_launch_counts()
    _, got = engine.render_many(state, events, **static)
    assert all(n > 0 for n in bk.launch_counts().values()), bk.launch_counts()
    for n in bk.KERNELS:
        monkeypatch.setattr(bk, n, getattr(bk, n + "_plain"))
    _, want = engine.render_many(state, events, **static)
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
