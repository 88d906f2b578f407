"""The idle, op-count, eager-glue, roofline and percentile arithmetic on a
synthetic trace, and a stall in the window moving block_ms_p95 and
voice_rtf.wall."""

import statistics
import time

import pytest
import torch

from portbench.harness import readers, spec, trace, work
from portbench.harness.main import Ctx
from portbench.harness.traffic import EventTable
from portbench.harness.window import Window, run_window
from small import CPU, OVERRIDES


def _ctx(tr, cfg=None, window=None):
    cfg = cfg or spec.config("drum_kit_bus7")
    return Ctx(cell={}, config=cfg, traffic={}, window=window or Window(), trace=tr,
               port_kernels={"affine1_stage_kernel", "mix_bank_sum_kernel"})


def _synthetic():
    # a 1,000 us window of 2 blocks: kernels at [100, 300), [250, 400) (overlap),
    # [600, 700); a copy at [800, 850)
    ops = [("void affine1_stage_kernel<4>(float const*)", 100.0, 200.0),
           ("void at::native::vectorized_elementwise_kernel<4>(int)", 250.0, 150.0),
           ("mix_bank_sum_kernel", 600.0, 100.0),
           ("Memcpy HtoD (Pageable -> Device)", 800.0, 50.0)]
    return trace.Trace(blocks=2, window_us=1000.0, busy_us=450.0, ops=ops,
                       gaps=[("render_all", 100.0), ("copy_out", 200.0), ("render_all", 150.0),
                             ("harness", 100.0)])


def test_idle_ops_eager():
    ctx = _ctx(_synthetic())
    assert readers.idle_pct(ctx) == pytest.approx(55.0)
    assert readers.ops_per_block(ctx) == 2.0
    assert readers.ops_per_block(ctx, lambda n: "HtoD" in n) == 0.5
    # glue: the ATen kernel (150 us) and the copy (50 us) over 2 blocks
    assert readers.eager_device_ms_per_block(ctx) == pytest.approx(0.1)


def test_busy_union_from_profiler_events():
    from torch.autograd import DeviceType

    class E:
        def __init__(self, name, s, e):
            self.name, self.device_type = name, DeviceType.CUDA
            self.time_range = type("R", (), {"start": s, "end": e})()

    t = trace.Tracer(CPU, 2)
    t.done, t._t_open, t._t_close = 2, 10.0, 10.001           # a 1,000 us stretch
    # the marker at device time 5,000 us is the stretch's start
    t._prof = type("P", (), {"events": lambda self: [
        E("void at::cuda::spin_kernel(long)", 5000.0, 5002.0), E("k1", 5100.0, 5300.0),
        E("k2", 5250.0, 5400.0), E("k3", 5600.0, 5700.0), E("portbench.render_all", 5000.0,
                                                             5900.0)]})()
    t.span("render_all", 10.0, 10.00045)
    t.span("copy_out", 10.00045, 10.001)
    tr = t.result()
    assert tr.busy_us == pytest.approx(400.0)
    assert tr.window_us == pytest.approx(1000.0)
    assert [n for n, _s, _d in tr.ops] == ["k1", "k2", "k3"]
    gaps = {}
    for n, d in tr.gaps:
        gaps[n] = gaps.get(n, 0.0) + d
    assert gaps == pytest.approx({"render_all": 100.0, "copy_out": 200.0 + 300.0})
    b = trace.breakdown(tr)
    assert b["device_ops"][0] == ["k1", pytest.approx(200e-6)]
    assert b["idle_gaps"][0] == ["copy_out", pytest.approx(500e-6)]


def test_roofline_least_time():
    table = {"group": "g", "sources": [], "unit_voices": {"kick": 2, "bass": 1},
             "launches": [{"kernel": "a", "ops": [0.0, 67e6], "bytes": [3.35e6, 0.0]},
                          {"kernel": "b", "ops": [67e6, 0.0], "bytes": [0.0, 0.0]}]}
    cfg = {"voices": {"kick": 20, "bass": 10}, "block_size": 512}
    # s = 10: a takes max(1 us of ops, 10 us of bytes), b 10 us of ops
    assert work.least_seconds(cfg, table) == pytest.approx(20e-6)
    with pytest.raises(ValueError):
        work.least_seconds({"voices": {"kick": 20, "bass": 20}, "block_size": 512}, table)


def test_roofline_share_and_silence(monkeypatch):
    tr = _synthetic()
    ctx = _ctx(tr, cfg={"voices": {"kick": 2}, "block_size": 512})
    table = {"group": "g", "sources": ["x.cu"], "unit_voices": {"kick": 2},
             "launches": [{"kernel": "a", "ops": [0.0, 0.0], "bytes": [3.35e12 * 50e-6, 0.0]}]}
    monkeypatch.setattr(ctx, "work", lambda name: table)
    monkeypatch.setattr(work, "kernel_names", lambda sources: {"affine1_stage_kernel"})
    # 50 us least a block, 2 blocks, 200 us of the group's kernel
    assert readers.roofline_pct(ctx, "g") == pytest.approx(50.0)
    monkeypatch.setattr(work, "kernel_names", lambda sources: {"not_in_trace"})
    assert readers.roofline_pct(ctx, "g") is None


def test_kernel_names_from_sources():
    names = work.port_kernel_names()
    assert "mix_bank_sum_kernel" in names and len(names) >= 15
    assert work.base_name("void walk_lone_kernel<LowpassLone>(float*, int)") == "walk_lone_kernel"
    assert work.base_name("void at::native::(anonymous namespace)::k<4>(int)") == "k"


def test_percentile_matches_statistics():
    vals = [float(v) for v in range(1, 201)]
    assert readers.percentile(vals, 95) == statistics.quantiles(vals, n=100,
                                                                 method="inclusive")[94]
    assert readers.percentile([1.0], 95) is None


class _Sleepy:
    """A stand-in system whose blocks take ``dt`` seconds, ``stall`` more in
    each block of ``stalled``."""

    has_chain = False

    def __init__(self, dt, stall=0.0, stalled=()):
        self.dt, self.stall, self.stalled, self.n = dt, stall, set(stalled), 0

    def initial_state(self):
        return {"x": torch.zeros(1)}

    def upload(self, ev):
        return {k: torch.as_tensor(v) for k, v in ev.items()}

    def render(self, state, ev):
        time.sleep(self.dt + (self.stall if self.n in self.stalled else 0.0))
        self.n += 1
        return {"x": state["x"] + 1}, torch.zeros(2, 64), torch.zeros(64)


@pytest.mark.parametrize("client", ["block", "chunked"])
def test_stall_moves_p95_and_rtf(client):
    cfg = spec.config("drum_kit_bus7")
    cfg.update(OVERRIDES["config"])
    mix = spec.traffic("wide")
    mix.update(OVERRIDES["traffic"])
    mix["client"] = {"kind": client, "chunk_blocks": 4}
    table = EventTable(cfg, mix, 1)
    reads = {}
    for label, sys_ in (("steady", _Sleepy(0.004)),
                        ("stalled", _Sleepy(0.004, 0.05, range(10, 100, 10)))):
        w = run_window(sys_, table, mix, seconds=0.6, seed=1, trace=False, device=CPU,
                       setup_clock=lambda: 1.0)
        ctx = _ctx(None, cfg=cfg, window=w)
        reads[label] = (spec.reader("voice_rtf.wall")(ctx), spec.reader("block_ms_p95")(ctx))
    assert reads["stalled"][0] < 0.8 * reads["steady"][0]
    if client == "block":
        assert reads["stalled"][1] > reads["steady"][1] + 30.0
