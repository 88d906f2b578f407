"""The port's WSOLA in its three forms against the JAX package's, both on
the CPU at 8 kHz (hops of 160 samples, as tests/test_wsola_stream.py runs
them): the host scheduler's plans bit for bit, ``search_hop`` with the same
indices, and the streamed hop loop (``stream_hops_batched``, through
``Mixer.render_blocks``) on noise with equal hop starts and audio within
1e-4 (the JAX hop loop reads through the interpret-mode Pallas grain
kernel, the port's through ``grain_read_cubic``'s plain version); batch
boundaries, and the ``MAX_STEP`` gate sending a channel to the host path
in both packages."""

import numpy as np
import pytest
import torch

from libgooey_tpu.mixer import loop_channel as jloop
from libgooey_tpu.mixer import mixer as jmixer
from libgooey_tpu.mixer import stereo_buffer as jsb
from libgooey_tpu.mixer import stream as jstream
from libgooey_tpu.mixer import wsola as jwsola
from libgooey_tpu.ops import wsola_search as jsearch
from libgooey_tpu.ops import wsola_stream as jdws

from libgooey_tpu_torch.mixer import loop_channel as tloop
from libgooey_tpu_torch.mixer import mixer as tmixer
from libgooey_tpu_torch.mixer import stereo_buffer as tsb
from libgooey_tpu_torch.mixer import stream as tstream
from libgooey_tpu_torch.mixer import wsola as twsola
from libgooey_tpu_torch.ops import wsola_stream as tdws

SR = 8000.0
B = 256
TOL = 1e-4


def _noise(n, seed):
    return (np.random.RandomState(seed).randn(n) * 0.3).astype(np.float32)


class _Buf:
    """Minimal buffer stand-in: .left/.right/.sample_rate."""

    def __init__(self, mono, sr=SR):
        self.left = np.asarray(mono, np.float32) * 0.5
        self.right = np.asarray(mono, np.float32) * 0.5
        self.sample_rate = sr


def _plans(host, mono, win, warp, n_blocks, speed=1.0):
    buf = _Buf(mono)
    out = []
    for _ in range(n_blocks):
        pos, w, cur = host.plan_block(B, buf, win, 1.0, speed, warp)
        out.append((pos.copy(), w.copy(), cur, float(host.cur_start_v)))
    return out


@pytest.mark.parametrize("use_device", [False, True], ids=["host_search", "device_search"])
@pytest.mark.parametrize("wraps", [False, True])
def test_wsola_host_plans_equal_jax(use_device, wraps):
    """The port's scheduler (host numpy search, or the port's search_hop)
    against the JAX scheduler with the host search: every plan, cursor and
    grain start bit for bit."""
    L = 1 << 13
    mono = _noise(L, 7)
    win = (jloop.LoopWindow(lo=L * 0.75, hi=L * 0.25, span=L * 0.5, wraps=True, len=float(L))
           if wraps else jloop.LoopWindow(0.0, float(L), float(L), False, float(L)))
    want = _plans(jwsola.WsolaHost(SR, win.lo, use_device=False), mono, win, 1.6, 14)
    got = _plans(twsola.WsolaHost(SR, win.lo, use_device=use_device, device="cpu"),
                 mono, tloop.LoopWindow(*win), 1.6, 14)
    for (pw, ww, cw, sw), (pg, wg, cg, sg) in zip(want, got):
        np.testing.assert_array_equal(pg, pw)
        np.testing.assert_array_equal(wg, ww)
        assert (cg, sg) == (cw, sw)


@pytest.mark.parametrize("wrap", [False, True])
def test_search_hop_indices_equal_jax(wrap):
    import jax.numpy as jnp

    rs = np.random.RandomState(11)
    hop = 160
    mono = (rs.randn(6000) * 0.4).astype(np.float32)
    for trial in range(6):
        ref = (rs.randn(hop) * 0.3).astype(np.float32)
        lo_b = float(rs.uniform(0, 3000))
        hi_b = lo_b + float(rs.uniform(20, 160))
        stride = max((hi_b - lo_b) / 64, 1.0)
        nc_valid = len(np.arange(lo_b, hi_b + 1e-9, stride))
        args = [np.float32(v) for v in (lo_b, hi_b, stride, 1.0 + 0.1 * trial, 4000.0,
                                        1500.0 if wrap else 0.0, 6000.0 if wrap else 1.0)]
        want = jsearch.search_hop(jnp.asarray(mono), jnp.asarray(ref), *args,
                                  np.int32(nc_valid), hop=hop, wrap=wrap, nc=65, nf=11)
        got = tsearch_hop(mono, ref, args, nc_valid, hop, wrap)
        assert got == [int(x) for x in want], (trial, got, want)


def tsearch_hop(mono, ref, args, nc_valid, hop, wrap):
    from libgooey_tpu_torch.ops import wsola_search

    return wsola_search.search_hop(torch.as_tensor(mono), torch.as_tensor(ref), *args,
                                   nc_valid, hop=hop, wrap=wrap, nc=65, nf=11).tolist()


# --- the streamed hop loop -----------------------------------------------------------


def _mixer(pkg, bufs, *, bpm=180.0, speed=1.0, window=None):
    sb, loop, mixer = pkg
    kw = {} if mixer is jmixer else {"device": "cpu"}
    m = mixer.Mixer(SR, block_size=B, buffer_capacity=1 << 14, **kw)
    m.set_bpm(bpm)
    for ch, (left, right) in zip(m.channels, bufs):
        ch.set_buffer(sb.StereoSampleBuffer.from_channels(left, right, SR, 120.0))
        ch.pitch_mode = loop.PITCH_PRESERVE
        ch.speed = speed
        if window is not None:
            ch.set_loop_window(*window)
        ch.set_playing(True)
    return m


JPKG, TPKG = (jsb, jloop, jmixer), (tsb, tloop, tmixer)


@pytest.fixture
def device_search(monkeypatch):
    monkeypatch.setattr(jwsola, "USE_DEVICE_SEARCH", True)
    monkeypatch.setattr(twsola, "USE_DEVICE_SEARCH", True)


def _stream(pkg, bufs, calls, **kw):
    m = _mixer(pkg, bufs, **kw)
    smod = jstream if pkg is JPKG else tstream
    assert all(smod.stream_config(m, i) is not None for i in range(len(bufs)))
    out = np.concatenate([np.asarray(m.render_blocks(k)) for k in calls], axis=-1)
    starts = [(ch._stretcher.cur_start_v, ch._stretcher.prev_start_v, ch.cursor)
              for ch in m.channels[:len(bufs)]]
    return out, starts, m


def _bufs(n_ch, n=1 << 13, seed=1):
    return [(_noise(n, seed + 2 * c), _noise(n, seed + 2 * c + 1)) for c in range(n_ch)]


@pytest.mark.parametrize("case", [
    dict(n_ch=2, calls=[6]),
    dict(n_ch=1, calls=[6], bpm=90.0, speed=1.3),
    dict(n_ch=2, calls=[6], window=(0.7, 0.45)),
    dict(n_ch=1, calls=[10], n=3000),
], ids=["two_channels", "warp_down_speed", "wrap_window", "loop_seam"])
def test_streamed_render_blocks_match_jax(device_search, case):
    """Hop starts (each channel's last two grains and its cursor, written
    back from the device) equal; audio within 1e-4."""
    bufs = _bufs(case["n_ch"], case.get("n", 1 << 13))
    kw = {k: case[k] for k in ("bpm", "speed", "window") if k in case}
    want, ws, _ = _stream(JPKG, bufs, case["calls"], **kw)
    got, gs, tm = _stream(TPKG, bufs, case["calls"], **kw)
    assert tm.streamed_channels == case["n_ch"]
    assert gs == ws
    assert np.abs(want).max() > 1e-3 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_stream_hops_batched_matches_jax():
    """One batched hop loop, two channels of different lengths and hop
    counts: every hop's start pair equal, the overlap-added hops within
    1e-4, the carried state too."""
    import jax.numpy as jnp

    L0, L1 = 5000, 4200
    cfgs = [jdws.make_config(SR, SR, L, 0.0, float(L), False, 1.0, 1.5) for L in (L0, L1)]
    U = max(c.U for c in cfgs)
    nf = max(c.nf for c in cfgs)
    Wmax = max(L0, L1) + 4 + U
    rows = []
    for c, L in enumerate((L0, L1)):
        lr = np.stack([_noise(L, 30 + c), _noise(L, 40 + c)])
        r = np.concatenate([lr.sum(0, keepdims=True), lr])
        p = np.concatenate([np.repeat(r[:, :1], 4, 1), r, np.repeat(r[:, -1:], U, 1)], 1)
        rows.append(np.pad(p, ((0, 0), (0, Wmax - p.shape[1]))))
    P3c = np.stack(rows).astype(np.float32)
    hop = cfgs[0].hop
    w = (np.sin(np.pi * np.arange(2 * hop) / (2 * hop)) ** 2).astype(np.float32)
    rs = np.random.RandomState(5)
    state = (np.array([100.0, 37.0], np.float32), np.array([0.25, 0.5], np.float32),
             np.array([True, False]), (rs.randn(2, hop) * 0.2).astype(np.float32),
             (rs.randn(2, 2, hop) * 0.2).astype(np.float32))
    n_active = np.array([6, 4])
    dyn = [jdws._static_dyn(c) for c in cfgs]
    shared = cfgs[0]._replace(U=U, nf=nf)
    jd = {k: jnp.asarray([d[k] for d in dyn], jnp.float32) for k in dyn[0]}
    jst = ((jnp.asarray(state[0]), jnp.asarray(state[1])), jnp.asarray(state[2]),
           jnp.asarray(state[3]), jnp.asarray(state[4]))
    jc, jbi, jbf, jhp, jys = jdws.stream_hops_batched(
        jnp.asarray(P3c), jnp.asarray(w[:hop]), jnp.asarray(w[hop:]), jst,
        jnp.asarray(n_active), jd, n_hops=6, cfg=shared)
    tcfg = tdws.StreamConfig(**{f: getattr(shared, f) for f in tdws.StreamConfig._fields})
    tc, tbi, tbf, thp, tys = tdws.stream_hops_batched(
        torch.as_tensor(P3c), torch.as_tensor(w[:hop]), torch.as_tensor(w[hop:]),
        tdws.state_tuple(state), n_active, tdws.dyn_tensors(dyn, "cpu"), n_hops=6, cfg=tcfg)
    for c, n in enumerate(n_active):
        np.testing.assert_array_equal(tbi.numpy()[:n, c], np.asarray(jbi)[:n, c])
        np.testing.assert_array_equal(tbf.numpy()[:n, c], np.asarray(jbf)[:n, c])
        np.testing.assert_array_equal(thp.numpy()[:n, c], np.asarray(jhp)[:n, c])
        np.testing.assert_allclose(tys.numpy()[:n, c], np.asarray(jys)[:n, c], atol=TOL, rtol=0)
    for a, b in zip(torch.utils._pytree.tree_leaves(tc), [jc[0][0], jc[0][1], *jc[1:]]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=0)


def test_stream_batch_boundaries_are_seamless(device_search):
    """Three batches render what one batch renders (the float64 write-back
    between batches against the float32 carry inside one)."""
    bufs = _bufs(1, seed=3)
    one, s1, _ = _stream(TPKG, bufs, [12])
    three, s3, _ = _stream(TPKG, bufs, [3, 5, 4])
    np.testing.assert_allclose(three, one, atol=TOL, rtol=0)
    assert abs(s3[0][2] - s1[0][2]) < 1e-3


def test_streamed_then_host_path_matches_per_block_host(device_search):
    """A streamed batch, then per-block renders with the host search: the
    written-back scheduler state continues the host path's hop sequence
    (tests/test_wsola_stream.py's 1.5e-3)."""
    bufs = _bufs(1, seed=4)
    ref = _mixer(TPKG, bufs)
    ref.channels[0]._stretcher = twsola.WsolaHost(SR, ref.channels[0].cursor, use_device=False,
                                                  device="cpu")
    want = np.concatenate([np.asarray(ref.render_block()) for _ in range(12)], axis=-1)
    m = _mixer(TPKG, bufs)
    first = np.asarray(m.render_blocks(6))
    assert m.streamed_channels == 1
    m.channels[0]._stretcher.use_device = False
    rest = [np.asarray(m.render_block()) for _ in range(6)]
    np.testing.assert_allclose(np.concatenate([first] + rest, axis=-1), want, atol=1.5e-3,
                               rtol=0)


def test_max_step_gate_sends_both_packages_to_the_host_path(device_search):
    """At step 6.6 (> MAX_STEP - 0.5) neither package streams; the host path
    renders the same audio; at 6.4 both stream."""
    for speed, streams in ((6.6, False), (6.4, True)):
        cfgs = [smod.stream_config(_mixer(pkg, _bufs(1, n=1 << 14), speed=speed), 0)
                for smod, pkg in ((jstream, JPKG), (tstream, TPKG))]
        assert [c is not None for c in cfgs] == [streams, streams], speed
    assert tdws.MAX_STEP == jdws.MAX_STEP
    bufs = _bufs(1, n=1 << 14, seed=9)
    jm, tm = _mixer(JPKG, bufs, speed=6.6), _mixer(TPKG, bufs, speed=6.6)
    want, got = np.asarray(jm.render_blocks(3)), np.asarray(tm.render_blocks(3))
    assert tm.streamed_channels == 0
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_stream_hops_single_channel_matches_jax():
    """The single-channel hop loop (``stream_hops``, the JAX package's
    candidates read from the mono row alone) against the JAX one: hop
    starts equal, hops within 1e-4."""
    import jax.numpy as jnp

    L = 5000
    cfg = jdws.make_config(SR, SR, L, 0.0, float(L), False, 1.0, 1.5)
    lr = np.stack([_noise(L, 50), _noise(L, 51)])
    rows = np.concatenate([lr.sum(0, keepdims=True), lr]).astype(np.float32)
    hop = cfg.hop
    w = (np.sin(np.pi * np.arange(2 * hop) / (2 * hop)) ** 2).astype(np.float32)
    rs = np.random.RandomState(6)
    state = (np.float32(60.0), np.float32(0.375), True, (rs.randn(hop) * 0.2).astype(np.float32),
             (rs.randn(2, hop) * 0.2).astype(np.float32))
    _, jbi, jbf, jhp, jys = jdws.stream_hops(
        jdws.pad_buffer(jnp.asarray(rows), cfg), jnp.asarray(w[:hop]), jnp.asarray(w[hop:]),
        jdws.state_tuple(state), n_hops=5, cfg=cfg)
    tcfg = tdws.StreamConfig(**{f: getattr(cfg, f) for f in tdws.StreamConfig._fields})
    _, tbi, tbf, thp, tys = tdws.stream_hops(
        tdws.pad_buffer(torch.as_tensor(rows), tcfg), torch.as_tensor(w[:hop]),
        torch.as_tensor(w[hop:]), tdws.state_tuple(state), n_hops=5, cfg=tcfg)
    np.testing.assert_array_equal(tbi.numpy(), np.asarray(jbi))
    np.testing.assert_array_equal(tbf.numpy(), np.asarray(jbf))
    np.testing.assert_array_equal(thp.numpy(), np.asarray(jhp))
    np.testing.assert_allclose(tys.numpy(), np.asarray(jys), atol=TOL, rtol=0)


def test_single_channel_dispatch_matches_the_batched_one(device_search):
    """``stream._stream_channel`` (one channel's prefix, hop loop, tail and
    write-back in one call) renders what ``render_blocks``' batched path
    renders for a lone channel, and writes back the same row."""
    bufs = _bufs(1, seed=12)
    a, b = _mixer(TPKG, bufs), _mixer(TPKG, bufs)
    a.render_blocks(2)
    b.render_blocks(2)
    K = 5
    cfg = tstream.stream_config(b, 0, K)
    p = tstream._prep_channel(b, 0, K, cfg)
    ch = p["ch"]
    targets = torch.as_tensor(np.tile(np.array([ch.gain_target, 1.0], np.float32), (K, 1)))
    v = p["v"]
    bank, _states, wets, wb = tstream._stream_channel(
        p["buf2"], p["ppos"], p["pw"], p["r0"], np.floor(v), v - np.floor(v), p["have_prev"],
        p["ref_tail"], p["ptail_pos"], p["pvalid"],
        torch.as_tensor(p["host"].window[:cfg.hop]), torch.as_tensor(p["host"].window[cfg.hop:]),
        targets, b._gain_banks[0], tuple(ch.chain.states), tuple(ch.chain.targets_list()),
        cfg=cfg, n_hops=p["n_hops"], K=K, B=B, wrap_read=cfg.wraps,
        chain_key=ch.chain.static_key(), sample_rate=SR, coeff=b._coeff)
    want = a.render_blocks(K).numpy()
    np.testing.assert_allclose(wets.permute(1, 0, 2).reshape(2, -1).numpy(), want, atol=1e-6,
                               rtol=0)
    tstream._mk_finalize(b, 0, p, cfg)(wb.numpy())
    sa, sb = a.channels[0]._stretcher, b.channels[0]._stretcher
    assert (sb.cur_start_v, sb.prev_start_v, sb.drain_idx) == (sa.cur_start_v, sa.prev_start_v,
                                                               sa.drain_idx)
