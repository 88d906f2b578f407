"""Oversampler validation: known-bin alias reduction in dB plus device
throughput in ns/sample (port of examples/antialias_validation.py; mirrors
the reference's examples/antialias_validation.rs:122-181, the same
tanh-drive measurement and the Off/2x/4x micro-bench).  The half-band
sections run in ``affine1_bank`` (ops/oversample.py)."""

import time

import numpy as np
import torch

from libgooey_tpu_torch import card_or
from libgooey_tpu_torch.examples import cut
from libgooey_tpu_torch.io_wav import write_wav
from libgooey_tpu_torch.ops import oversample as ov

SR = 48000.0
N = 8192
FUND = 10000.0
DRIVE = 10.0


def _drive(v):
    return torch.tanh(v * DRIVE)


def run(x, mode, *, device):
    st = ov.OversamplerState.init((), device)
    xs = torch.as_tensor(x, device=device)
    outs = []
    for i in range(0, len(x), 512):
        st, y = ov.process(st, _drive, xs[i:i + 512], mode)
        outs.append(y)
    return torch.cat(outs).cpu().numpy()


def coherent(sig, freq):
    t = np.arange(2000, len(sig))
    ph = 2 * np.pi * freq * t / SR
    s = sig[2000:]
    return np.hypot(np.dot(s, np.cos(ph)), np.dot(s, np.sin(ph)))


def bench_mode(mode, n=1 << 20, *, device):
    """Device throughput, ns/sample (the whole buffer through the chain in
    one call): on the card CUDA events around 5 calls after a warm-up call
    and a synchronize; on the CPU the host clock."""
    x = (np.sin(2 * np.pi * FUND * np.arange(n) / SR) * 0.8).astype(np.float32)
    xx = torch.as_tensor(x, device=device)

    def f():
        st = ov.OversamplerState.init((), device)
        return ov.process(st, _drive, xx, mode)[1]

    reps = 5
    f()                                            # warm-up
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            f()
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) * 1e-3 / reps
    else:
        t0 = time.perf_counter()
        for _ in range(reps):
            f()
        dt = (time.perf_counter() - t0) / reps
    return dt / n * 1e9


def main(quick: bool = False, *, device=None, blocks=None, out_dir: str = "/tmp"):
    """Returns ``{"alias_db": {2: dB, 4: dB}, "ns_per_sample": {1: .., 2: ..,
    4: ..}}``.  ``blocks`` cuts the micro-bench's buffer (the alias
    measurement keeps its 8,192 samples); ``out_dir``: where the WAVs go."""
    dev = card_or(device, "antialias_validation example")
    t = np.arange(N)
    x = (np.sin(2 * np.pi * FUND * t / SR) * 0.8).astype(np.float32)
    base = run(x, 1, device=dev)
    x2 = run(x, 2, device=dev)
    x4 = run(x, 4, device=dev)
    # 3rd harmonic (30 kHz) folds to 18 kHz at the base rate
    alias_bin = 18000.0
    p_off = coherent(base, alias_bin)
    alias_db = {m: float(20 * np.log10(p_off / max(coherent(y, alias_bin), 1e-12)))
                for m, y in ((2, x2), (4, x4))}
    print(f"2x known-bin alias reduction versus off: {alias_db[2]:.2f} dB")
    print(f"4x known-bin alias reduction versus off: {alias_db[4]:.2f} dB")

    for name, sig in (("base-rate-sweep", base), ("oversampled-2x-sweep", x2),
                      ("oversampled-4x-sweep", x4)):
        path = f"{out_dir}/gooey_{name}.wav"
        write_wav(path, sig, int(SR), bits=32)
        print(f"Wrote {path}")

    (bn,) = cut([1 << 16 if quick else 1 << 20], blocks)
    ns = {m: bench_mode(m, bn, device=dev) for m in (1, 2, 4)}
    print(f"Off throughput: {ns[1]:.2f} ns/sample")
    print(f"2x throughput: {ns[2]:.2f} ns/sample ({ns[2] / ns[1]:.2f}x off cost)")
    print(f"4x throughput: {ns[4]:.2f} ns/sample ({ns[4] / ns[1]:.2f}x off cost)")
    return {"alias_db": alias_db, "ns_per_sample": ns}


if __name__ == "__main__":
    main()
