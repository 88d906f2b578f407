"""The CUDA bank kernels against their plain versions, on the card.

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
    ]


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
