"""The port's bank kernels (plain versions, on the CPU) against the JAX
package's Pallas wrappers run in interpret mode, and the port modules that
call them against the JAX package's modules.

The same numpy inputs feed both packages.  Tolerances: the plain versions
keep the Pallas bodies' per-sample op order, so the four small recurrences
agree to ~1e-7 (bound 1e-6; XLA:CPU may contract a multiply-add into an FMA
where PyTorch rounds twice).  The fused waveshaper chain runs 32 allpass
sections and 4 tanh per sample (bound 1e-5 on the output and every carried
state field).  V = 130 crosses a 128-lane group of the TPU layout.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from libgooey_tpu.effects import feedback_waveshaper as jfw
from libgooey_tpu.ops import filters as jfilters
from libgooey_tpu.ops import noise as jnoise
from libgooey_tpu.ops import pallas_fx
from libgooey_tpu.ops import scan as jscan

from libgooey_tpu_torch import interop
from libgooey_tpu_torch.effects import feedback_waveshaper as tfw
from libgooey_tpu_torch.ops import bank_kernels as bk
from libgooey_tpu_torch.ops import filters as tfilters
from libgooey_tpu_torch.ops import kernels
from libgooey_tpu_torch.ops import noise as tnoise
from libgooey_tpu_torch.ops import scan as tscan

SR = 44100.0
V, B = 130, 128


def T(a):
    return torch.from_numpy(np.array(a))


def err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def tree_err(ja, tb) -> float:
    """Worst leaf error between a JAX state tree and a port state tree."""
    la = jax.tree_util.tree_leaves(ja)
    lb = jax.tree_util.tree_leaves(tuple(interop.to_numpy(tb)))
    assert len(la) == len(lb)
    return max(err(a, b) for a, b in zip(la, lb))


@pytest.mark.parametrize("mode", ["linear", "max_affine"])
def test_affine1_bank_matches_jax(mode):
    rs = np.random.RandomState(17)
    if mode == "linear":
        a = np.full((V, B), -3.0e38, np.float32)
        b = rs.uniform(0.9, 1.0, (V, B)).astype(np.float32)
        c = (0.02 * rs.randn(V, B)).astype(np.float32)
    else:  # hihat2-style instant-up / smoothed-down tracker
        a = np.abs(rs.randn(V, B)).astype(np.float32)
        b = np.full((V, B), 0.96, np.float32)
        c = (np.float32(0.04) * a).astype(np.float32)
    y0 = (0.1 * rs.randn(V)).astype(np.float32)
    yj, ylj = pallas_fx.affine1_bank(a, b, c, y0, interpret=True)
    yt, ylt = bk.affine1_bank(T(a), T(b), T(c), T(y0))
    assert err(yj, yt) <= 1e-6
    assert err(ylj, ylt) <= 1e-6


def test_pink_bank_matches_jax():
    rs = np.random.RandomState(21)
    poles, gains = jnoise.coefficients(SR)
    kw = dict(poles=tuple(map(float, poles)), gains=tuple(map(float, gains)),
              direct=float(jnoise.DIRECT_GAIN), outg=float(jnoise.OUTPUT_GAIN))
    w = rs.uniform(-1, 1, (V, B)).astype(np.float32)
    reset = rs.rand(V, B) < 0.01
    fstate = (0.3 * rs.randn(V, 3)).astype(np.float32)
    pj, fj = pallas_fx.pink_bank(w, reset, fstate, interpret=True, **kw)
    pt, ft = bk.pink_bank(T(w), T(reset), T(fstate), **kw)
    assert err(pj, pt) <= 1e-6
    assert err(fj, ft) <= 1e-6


def test_pink_bank_without_a_mask_matches_jax():
    """hihat2's call: no reset mask (the kernel instantiates no mask code)."""
    rs = np.random.RandomState(22)
    poles, gains = jnoise.coefficients(SR)
    kw = dict(poles=tuple(map(float, poles)), gains=tuple(map(float, gains)),
              direct=float(jnoise.DIRECT_GAIN), outg=float(jnoise.OUTPUT_GAIN))
    w = rs.uniform(-1, 1, (V, B)).astype(np.float32)
    fstate = (0.3 * rs.randn(V, 3)).astype(np.float32)
    pj, fj = pallas_fx.pink_bank(w, None, fstate, interpret=True, **kw)
    pt, ft = bk.pink_bank(T(w), None, T(fstate), **kw)
    assert err(pj, pt) <= 1e-6
    assert err(fj, ft) <= 1e-6
    assert float(np.abs(fj).max()) > 0.1


def test_svf_bank_matches_jax():
    rs = np.random.RandomState(12)
    x = rs.randn(V, B).astype(np.float32)
    g, h = jfilters.svf_coeffs(jnp.asarray((200 + 8000 * rs.rand(V, B)).astype(np.float32)),
                               0.9, SR)
    g, h = np.asarray(g), np.asarray(h)
    reset = rs.rand(V, B) < 0.01
    ic1 = (0.1 * rs.randn(V)).astype(np.float32)
    ic2 = (0.1 * rs.randn(V)).astype(np.float32)
    want = pallas_fx.svf_bank(x, g, h, reset, ic1, ic2, interpret=True)
    got = bk.svf_bank(T(x), T(g), T(h), T(reset), T(ic1), T(ic2))
    for name, a, b in zip(("v1", "v2", "ic1", "ic2"), want, got):
        assert err(a, b) <= 1e-6, name


@pytest.mark.parametrize("R,n", [(1, 128), (130, 100), (130, 37), (1, 37)])
def test_svf_bank_tails_match_jax(R, n):
    """One row, a tail of the kernel's 64-sample chunk (100) and 4-byte
    copies (37), with resets on the first and the last sample of every row
    (and a mask-free block at one row of 37)."""
    rs = np.random.RandomState(R + n)
    x = rs.randn(R, n).astype(np.float32)
    g, h = jfilters.svf_coeffs(jnp.asarray((200 + 8000 * rs.rand(R, n)).astype(np.float32)),
                               0.9, SR)
    g, h = np.asarray(g), np.asarray(h)
    reset = rs.rand(R, n) < 0.02
    reset[:, 0] = reset[:, -1] = True
    if (R, n) == (1, 37):
        reset = None
    ic1 = (0.1 * rs.randn(R)).astype(np.float32)
    ic2 = (0.1 * rs.randn(R)).astype(np.float32)
    want = pallas_fx.svf_bank(x, g, h, reset, ic1, ic2, interpret=True)
    got = bk.svf_bank(T(x), T(g), T(h), None if reset is None else T(reset), T(ic1), T(ic2))
    for name, a, b in zip(("v1", "v2", "ic1", "ic2"), want, got):
        assert b.shape == a.shape
        assert err(a, b) <= 1e-6, name


def test_env_follow_bank_matches_jax():
    rs = np.random.RandomState(11)
    att, rel = jfw.env_coeffs(SR)
    rect = np.abs(rs.randn(V, B)).astype(np.float32)
    freeze = rs.rand(V, B) < 0.1
    env0 = np.abs(rs.randn(V)).astype(np.float32)
    ej, elj = pallas_fx.env_follow_bank(rect, freeze.astype(np.float32), env0,
                                        att=att, rel=rel, interpret=True)
    et, elt = bk.env_follow_bank(T(rect), T(freeze), T(env0), att=att, rel=rel)
    assert err(ej, et) <= 1e-6
    assert err(elj, elt) <= 1e-6


@pytest.mark.parametrize("R,n", [(1, 128), (130, 100), (130, 99), (16, 512)])
def test_env_follow_bank_tails_match_jax(R, n):
    """One row, a tail of the kernel's 64-sample chunk (100), 4-byte copies
    and the mask byte by byte (99), and the product kit's 16 rows, with
    freezes on the first and the last sample of every row."""
    rs = np.random.RandomState(R + n)
    att, rel = jfw.env_coeffs(SR)
    rect = np.abs(rs.randn(R, n)).astype(np.float32)
    freeze = rs.rand(R, n) < 0.1
    freeze[:, 0] = freeze[:, -1] = True
    env0 = np.abs(rs.randn(R)).astype(np.float32)
    ej, elj = pallas_fx.env_follow_bank(rect, freeze.astype(np.float32), env0,
                                        att=att, rel=rel, interpret=True)
    et, elt = bk.env_follow_bank(T(rect), T(freeze), T(env0), att=att, rel=rel)
    assert et.shape == ej.shape
    assert err(ej, et) <= 1e-6
    assert err(elj, elt) <= 1e-6


def test_fbws_bank_matches_jax_over_blocks():
    """Two blocks threaded through each package's pack/unpack: the dc output
    and every unpacked state field, including the ``*y2``/``*x2`` captures."""
    rs = np.random.RandomState(5)
    jst = jfw.FBShaperState.init((V,))
    tst = tfw.FBShaperState.init((V,), "cpu")
    for _ in range(2):
        u = ((0.5 + 3.0 * rs.rand(V, B)) * 0.5 * rs.randn(V, B)).astype(np.float32)
        cs = np.where(rs.rand(V, B) < 0.05, -1.0,
                      0.2 + 2.8 * rs.rand(V, B)).astype(np.float32)
        dj, nj = pallas_fx.fbws_bank(u, cs, pallas_fx.pack_fbws_bank(jst), interpret=True)
        dt, nt = bk.fbws_bank(T(u), T(cs), bk.pack_fbws_bank(tst))
        assert tuple(nt.shape) == (bk.FBWS_S_OUT, V) == tuple(nj.shape)
        assert err(dj, dt) <= 1e-5
        ovj, xj, yj = pallas_fx.unpack_fbws_bank(nj, jst)
        jst = jst._replace(ovs=ovj, dc_x1=xj, dc_y1=yj)
        ovt, xt, yt = bk.unpack_fbws_bank(nt, tst)
        tst = tst._replace(ovs=ovt, dc_x1=xt, dc_y1=yt)
        for hb in ("up1", "up2", "down2", "down1"):
            for f in jst.ovs.up1._fields:
                a = getattr(getattr(jst.ovs, hb), f)
                b = getattr(getattr(tst.ovs, hb), f)
                assert err(a, b) <= 1e-5, f"{hb}.{f}"
        assert err(jst.dc_x1, tst.dc_x1) <= 1e-5
        assert err(jst.dc_y1, tst.dc_y1) <= 1e-5


# --- the port modules that call the kernels, against the JAX modules ---------
# (JAX's CPU path here is its associative-scan formulation: reassociation
# differs from the sequential bank by ~1e-7, bound 1e-6 / 1e-5.)

V2 = 8


def test_linrec1_matches_jax():
    rs = np.random.RandomState(3)
    a = rs.uniform(0.9, 1.0, (V2, B)).astype(np.float32)
    b = (0.02 * rs.randn(V2, B)).astype(np.float32)
    y0 = (0.1 * rs.randn(V2)).astype(np.float32)
    assert err(jscan.linrec1(a, b, y0), tscan.linrec1(T(a), T(b), T(y0))) <= 1e-6


def test_pink_block_matches_jax():
    rs = np.random.RandomState(4)
    counters = np.cumsum(rs.randint(1, 3, (V2, 2 * B)), -1).astype(np.int32)
    reset = rs.rand(V2, 2 * B) < 0.01
    sj = jnoise.PinkState.init((V2,))
    st = tnoise.PinkState.init((V2,), "cpu")
    for i in range(2):
        sl = slice(i * B, (i + 1) * B)
        sj, pj = jnoise.pink_block(sj, counters[:, sl], SR, reset=reset[:, sl])
        st, pt = tnoise.pink_block(st, T(counters[:, sl]), SR, reset=T(reset[:, sl]))
        assert err(pj, pt) <= 1e-6
        assert err(sj.fstate, st.fstate) <= 1e-5


def test_resonant_filters_match_jax():
    rs = np.random.RandomState(6)
    x = (0.3 * rs.randn(V2, B)).astype(np.float32)
    cut = (100 + 5000 * rs.rand(V2, B)).astype(np.float32)
    q = (0.5 + 4.0 * rs.rand(V2, B)).astype(np.float32)
    reset = rs.rand(V2, B) < 0.02
    sj, oj = jfilters.resonant_lowpass_block(jfilters.SVFState.init((V2,)), x, cut, q, SR,
                                             reset=reset)
    st, ot = tfilters.resonant_lowpass_block(tfilters.SVFState.init((V2,), "cpu"), T(x),
                                             T(cut), T(q), SR, reset=T(reset))
    assert err(oj, ot) <= 1e-6
    assert max(err(sj.ic1, st.ic1), err(sj.ic2, st.ic2)) <= 1e-6
    sj, oj = jfilters.resonant_highpass_block(jfilters.OnePoleState.init((V2,)), x, 8000.0,
                                              4.0, SR, reset=reset)
    st, ot = tfilters.resonant_highpass_block(tfilters.OnePoleState.init((V2,), "cpu"), T(x),
                                              8000.0, 4.0, SR, reset=T(reset))
    assert err(oj, ot) <= 1e-6
    assert err(sj.y, st.y) <= 1e-6


def test_feedback_waveshaper_matches_jax():
    """The zero-feedback 4x path over 3 blocks, drive crossing the bypass
    threshold; JAX runs its XLA scan formulation here."""
    rs = np.random.RandomState(7)
    jst = jfw.FBShaperState.init((V2,))
    tst = tfw.FBShaperState.init((V2,), "cpu")
    for _ in range(3):
        x = (0.5 * rs.randn(V2, B)).astype(np.float32)
        d = (0.5 + 3.0 * rs.rand(V2, B)).astype(np.float32)
        f = (0.1 + 0.5 * rs.rand(V2, B)).astype(np.float32)
        jst, oj = jfw.process_block(jst, jnp.asarray(x), jnp.asarray(d),
                                    jnp.zeros((V2, B), jnp.float32), jnp.asarray(f),
                                    jnp.float32(1.0), SR, feedback_path=False, os_mode=4)
        tst, ot = tfw.process_block(tst, T(x), T(d), torch.zeros(V2, B), T(f), 1.0, SR,
                                    feedback_path=False, os_mode=4)
        assert err(oj, ot) <= 1e-5
        assert tree_err(jst, tst) <= 1e-5


# --- affine1 with no floor array; the staged kernels' launch geometry ---------


def _floorless_rows(rs, R, n):
    """``b, c, y0`` of the floorless recurrence with a NaN, +inf, -inf and
    values below the -3e38 floor in ``c``, each in rows of its own (a NaN
    stays in its row), and a sprinkle of each in the rest."""
    b = rs.uniform(-0.99, 0.99, (R, n)).astype(np.float32)
    c = rs.randn(R, n).astype(np.float32)
    c[0, n // 2] = np.nan
    c[1, n // 3] = np.inf
    c[2, ::7] = -np.inf
    c[3, ::5] = -3.2e38
    c[4, ::3] = -3.4e38
    for value in (np.nan, np.inf, -np.inf, -3.3e38):
        c[5:][rs.rand(R - 5, n) < 0.002] = value
    return b, c, rs.randn(R).astype(np.float32)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("R,n", [(5, 37), (V, B)])
@pytest.mark.parametrize("via", ["affine1_bank", "linrec1"])
def test_no_floor_equals_the_explicit_floor_bit_for_bit(via, R, n):
    """``affine1_bank(None, ...)`` and ``scan.linrec1`` (which passes None)
    give the bits of the explicit ``NO_FLOOR`` row: NaN, +-inf and
    below-floor values included (-inf and below-floor sums land on the
    floor)."""
    b, c, y0 = _floorless_rows(np.random.RandomState(11), R, n)
    floor = torch.full((R, n), bk.NO_FLOOR)
    if via == "affine1_bank":
        got = bk.affine1_bank(None, T(b), T(c), T(y0))
        want = bk.affine1_bank(floor, T(b), T(c), T(y0))
    else:
        got = (tscan.linrec1(T(b), T(c), T(y0)),)
        want = (tscan.maxlin(floor, T(b), T(c), T(y0)),)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))
    y = got[0]
    assert torch.isnan(y[0]).any() and torch.isinf(y[1]).any()
    assert (y[2:5] == np.float32(bk.NO_FLOOR)).any(dim=1).all()


@pytest.mark.parametrize("R,rc", [(1, 1), (5, 1), (132, 1), (512, 4), (515, 4), (1024, 8),
                                  (2560, 20), (4096, 32), (100_000, 32)])
def test_staged_launches_spread_over_the_sms(R, rc):
    """Rows per block on 132 SMs: one block per SM at most, all 32 walkers
    of a warp once there are more rows than that, and a block for each row
    while rows are fewer than SMs."""
    assert bk.stage_rows(R, 132) == rc
    blocks = -(-R // rc)
    assert blocks >= min(R, 128)
    assert blocks <= 132 or rc == bk.STAGE_MAX_ROWS


def test_staged_launches_copy_16_bytes_only_where_every_row_is_aligned():
    x = torch.zeros(4 * 101 + 1)
    assert bk.copies_16b(100, x[:400].view(4, 100), None)
    assert not bk.copies_16b(99, x[:396].view(4, 99))
    assert not bk.copies_16b(100, x[:400].view(4, 100), x[1:401].view(4, 100))


def _recorded_launch(monkeypatch, fn, *args, n_coefs=0, **kw):
    """The C entry's arguments of one launch of wrapper ``fn`` on CPU
    tensors, as on a card of 132 SMs (recorded, not run), and the first
    ``n_coefs`` floats of its host coefficient array, read during the call."""
    import ctypes

    calls = []

    def record(name, device, entry, *a):
        ptr = next((x.value for x in a if isinstance(x, ctypes.c_void_p)), None)
        calls.append((entry, a, list((ctypes.c_float * n_coefs).from_address(ptr))
                      if n_coefs else None))

    monkeypatch.setattr(bk, "_on_cuda", lambda name, t: True)
    monkeypatch.setattr(bk, "_sm_count", lambda index: 132)
    monkeypatch.setattr(bk, "_launch", record)
    launches = fn.launches
    fn(*args, **kw)
    fn.launches = launches
    (call,) = calls
    return call


@pytest.mark.parametrize("R,n,rc,vec", [(1024, 512, 8, 1), (512, 512, 4, 1), (8, 512, 1, 1),
                                        (515, 99, 4, 0)])
def test_svf_bank_launches_staged(monkeypatch, R, n, rc, vec):
    """``svf_bank`` passes its rows per block and 16-byte flag as the staged
    kernels do (the reset mask's copy width is the kernel's own choice), and
    a null mask for ``reset=None``."""
    x = torch.zeros(R, n)
    ic = torch.zeros(R)
    for reset in (torch.zeros(R, n, dtype=torch.bool), None):
        entry, a, _ = _recorded_launch(monkeypatch, bk.svf_bank, x, x, x, reset, ic, ic)
        assert entry == "svf_bank_launch" and len(a) == 14
        assert a[3] == (None if reset is None else reset.data_ptr())
        assert a[10:] == (R, n, rc, vec) == (R, n, bk.stage_rows(R, 132), vec)


@pytest.mark.parametrize("R,n,rc,vec", [(4096, 512, 32, 1), (1024, 512, 8, 1), (16, 512, 1, 1),
                                        (515, 100, 4, 1), (515, 99, 4, 0)])
def test_env_follow_bank_launches_staged(monkeypatch, R, n, rc, vec):
    """``env_follow_bank`` passes its rows per block and 16-byte flag as the
    staged kernels do (the freeze mask's copy width is the kernel's own
    choice), the coefficients as float32 after them."""
    rect, env0 = torch.zeros(R, n), torch.zeros(R)
    freeze = torch.zeros(R, n, dtype=torch.bool)
    entry, a, _ = _recorded_launch(monkeypatch, bk.env_follow_bank, rect, freeze, env0,
                                   att=0.9776, rel=0.99981)
    assert entry == "env_follow_bank_launch" and len(a) == 11
    assert a[:3] == (rect.data_ptr(), freeze.data_ptr(), env0.data_ptr())
    assert a[5:7] == (0.9776, 0.99981)
    assert a[7:] == (R, n, rc, vec) == (R, n, bk.stage_rows(R, 132), vec)


@pytest.mark.parametrize("R,n,rc,vec", [(1024, 512, 8, 1), (512, 512, 4, 1), (1, 512, 1, 1),
                                        (515, 100, 4, 1), (515, 99, 4, 0)])
def test_ws4_bank_launches_with_the_raw_drive(monkeypatch, R, n, rc, vec):
    """``ws4_bank`` hands the kernel the raw drive (it computes the gain) and
    the chain's twelve coefficients followed by tanh(0.5) as the plain
    version rounds it, with rows per block as the staged kernels."""
    x, drive = torch.zeros(R, n), torch.ones(R, n)
    packed = torch.zeros(bk.FBWS_S_IN, R)
    entry, a, coefs = _recorded_launch(monkeypatch, bk.ws4_bank, x, drive, packed, n_coefs=13)
    assert entry == "ws4_bank_launch" and len(a) == 10
    assert a[1] == drive.data_ptr() and a[2] == packed.data_ptr()
    assert coefs == [float(np.float32(c)) for c in (*bk._FBWS_COEFS, bk._TANH_HALF)]
    assert a[6:] == (R, n, rc, vec)


@pytest.mark.parametrize("R,n,rc,vec", [(4096, 512, 32, 1), (1024, 512, 8, 1), (1, 512, 1, 1),
                                        (515, 100, 4, 1), (515, 99, 4, 0)])
def test_fbws_bank_launches_split(monkeypatch, R, n, rc, vec):
    """``fbws_bank`` passes rows per block and the 16-byte flag as the split
    ``ws4_bank`` does (32 rows a block at the kick slice's 4,096, 8 at the
    kit's 1,024), after the chain's twelve coefficients."""
    u, cs = torch.zeros(R, n), torch.ones(R, n)
    packed = torch.zeros(bk.FBWS_S_IN, R)
    entry, a, coefs = _recorded_launch(monkeypatch, bk.fbws_bank, u, cs, packed, n_coefs=12)
    assert entry == "fbws_bank_launch" and len(a) == 10
    assert a[:3] == (u.data_ptr(), cs.data_ptr(), packed.data_ptr())
    assert coefs == [float(np.float32(c)) for c in bk._FBWS_COEFS]
    assert a[6:] == (R, n, rc, vec) == (R, n, bk.stage_rows(R, 132), vec)


def test_ab_tools_call_older_entries_with_their_arguments(tmp_path):
    """``tools/torch_kernel_ab.py`` (and the CPU emulator's A/B) call a build
    from before the svf/ws4/env_follow/plate/fbws/triangle redesigns with
    its own arguments: the SVF, the follower and fbws without rows per block
    and 16-byte flag, ws4 with the wrapper's (d, comp) in place of the
    drive, the plate without its chunk, the triangle without its taper
    threshold; a build with this tree's entries unchanged."""
    import sys
    from pathlib import Path

    from libgooey_tpu_torch.ops import _build

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    from torch_kernel_ab import older_args, signatures

    older = dict(_build.SIGNATURES)
    P, I = _build._P, _build._I
    older["svf_bank_launch"] = [P] * 10 + [I, I, P]   # the entries' arguments before
    older["ws4_bank_launch"] = [P] * 7 + [I, I, P]
    older["env_follow_bank_launch"] = [P] * 5 + [_build._F, _build._F, I, I, P]
    older["plate_block_launch"] = [P] * 3 + [I, I, I, P]
    older["fbws_bank_launch"] = [P] * 6 + [I, I, P]
    F = _build._F
    older["triangle_additive_bank_launch"] = [P] * 3 + [F, F, I, I, I, P]
    (tmp_path / "ops").mkdir()
    names = {_build._P: "_P", _build._I: "_I", _build._F: "_F"}
    (tmp_path / "ops" / "_build.py").write_text(
        "import ctypes\n_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float\n"
        "SIGNATURES = {\n"
        + "".join(f"    {k!r}: [{', '.join(names[t] for t in v)}],\n" for k, v in older.items())
        + "}\n")
    (tmp_path / "csrc").mkdir()
    sigs = signatures(tmp_path / "csrc")
    assert len(sigs["svf_bank_launch"]) == 13 and len(sigs["ws4_bank_launch"]) == 10
    assert len(sigs["env_follow_bank_launch"]) == 10 and len(sigs["plate_block_launch"]) == 7
    assert len(sigs["fbws_bank_launch"]) == 9 and len(sigs["triangle_additive_bank_launch"]) == 9
    assert signatures(Path(bk.__file__).resolve().parents[1] / "csrc") == _build.SIGNATURES
    svf = tuple(range(100, 110)) + (7, 9, 1, 1)
    assert older_args("svf_bank_launch", svf, sigs, None) == svf[:12]
    assert older_args("svf_bank_launch", svf, _build.SIGNATURES, None) == svf
    ws4 = (1, 2, 3, 4, 5, 6, 7, 9, 1, 1)
    gains = []

    def gain(drive, V, B):
        gains.append((drive, V, B))
        return 11, 12

    assert older_args("ws4_bank_launch", ws4, sigs, gain) == (1, 11, 12, 3, 4, 5, 6, 7, 9)
    assert gains == [(2, 7, 9)]
    env = (1, 2, 3, 4, 5, 0.9776, 0.99981, 7, 9, 1, 1)
    assert older_args("env_follow_bank_launch", env, sigs, None) == env[:9]
    assert older_args("env_follow_bank_launch", env, _build.SIGNATURES, None) == env
    plate = (1, 2, 3, 566, 2719, 512, 158)
    assert older_args("plate_block_launch", plate, sigs, None) == plate[:6]
    assert older_args("plate_block_launch", plate, _build.SIGNATURES, None) == plate
    fbws = (1, 2, 3, 4, 5, 6, 4096, 512, 32, 1)
    assert older_args("fbws_bank_launch", fbws, sigs, None) == fbws[:8]
    assert older_args("fbws_bank_launch", fbws, _build.SIGNATURES, None) == fbws
    tri = (1, 2, 3, 1.4247e-4, 22050.0, 16537.502, 32, 1024, 512)
    assert older_args("triangle_additive_bank_launch", tri, sigs, None) == tri[:5] + tri[6:]
    assert older_args("triangle_additive_bank_launch", tri, _build.SIGNATURES, None) == tri
    sigs["sampler_read_linear_launch"] = sigs["sampler_read_linear_launch"][1:]
    with pytest.raises(ValueError, match="no older form"):
        older_args("sampler_read_linear_launch", (), sigs, gain)


def test_kernel_probes_apply_to_this_tree(tmp_path):
    """``tools/kernel_probes.py`` finds each of its edits once in this
    tree's sources (the split chain's, ``fbws_bank``'s rows per block,
    ``kit_drive``'s, the plate's) and writes a whole copy per probe."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    import kernel_probes

    assert kernel_probes.main([str(tmp_path)]) == 0
    csrc = Path(bk.__file__).resolve().parents[1] / "csrc"
    for name, (source, edits) in kernel_probes.PROBES.items():
        probe = tmp_path / name
        assert sorted(p.name for p in probe.iterdir()) == sorted(p.name for p in csrc.iterdir())
        text = (probe / source).read_text()
        assert all(new in text for _, new in edits) and text != (csrc / source).read_text()


@pytest.mark.parametrize("n", [512, 100, 37])
def test_mix_settled_test_covers_every_sample(n):
    """``mix_bank``'s kernel takes a voice's pan as settled for the block
    when ``|(cur - tgt) * w| < 1e-4`` at the largest power ``w``: at the
    snap's float32 edge (``chip_smoke.snap_edge_pans``) the plain version's
    snap zeroes every sample of the voices just below it, and not the first
    sample of those at it."""
    import sys
    from pathlib import Path

    from libgooey_tpu_torch.core.smoother import settle_snap, smoothing_coeff

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    pw = bk._mix_powers(smoothing_coeff(SR), n, "cpu")
    assert bool((pw[1:] <= pw[:-1]).all())
    pt = np.linspace(0.2, 0.8, 64).astype(np.float32)
    pc = chip_smoke.snap_edge_pans(pt, np.float32(pw.abs().max()))
    snapped = settle_snap((T(pc) - T(pt))[:, None] * pw[None, :]) == 0.0
    below = np.arange(64) % 4 < 2
    assert bool(snapped[below].all()) and not bool(snapped[~below, 0].any())
    assert bool(snapped[~below, -1].all())
    assert (pc > pt).tolist() == [i % 2 == 0 for i in range(64)]


# --- dispatch -----------------------------------------------------------------


def test_cpu_tensors_take_the_plain_versions_without_counting():
    kernels.reset_launch_counts()
    rs = np.random.RandomState(0)
    a = T(np.full((4, 16), -3.0e38, np.float32))
    b = T(rs.rand(4, 16).astype(np.float32))
    y, yl = bk.affine1_bank(a, b, b, torch.zeros(4))
    ref, _ = bk.affine1_bank_plain(a, b, b, torch.zeros(4))
    assert torch.equal(y, ref) and torch.equal(yl, y[:, -1])
    assert all(n == 0 for n in kernels.launch_counts().values())


def test_other_devices_raise_instead_of_falling_back():
    x = torch.empty(4, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        bk.affine1_bank(x, x, x, torch.empty(4, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        bk.fbws_bank(x, x, torch.empty(bk.FBWS_S_IN, 4, device="meta"))
