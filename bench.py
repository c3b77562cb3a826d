"""North-star benchmark: 256-channel FIR+FFT chain throughput on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.

- metric: fir_fft_256ch_throughput
- value: Msamples/s through the hand-compiled FIR(64-tap complex) ->
  FFT(1024) chain (parallel/chain.fir_fft_chain) on the GPU. The script
  refuses to run without one.
- vs_baseline: speedup vs an FFT-overlap-save numpy implementation of
  the same chain on this host (the reference PothosComms is a CPU/SIMD
  block library and publishes no numbers — BASELINE.md).
- eff_tflops: achieved FLOP rate of the EXECUTED work
  (parallel/profiling.chain_flops: the combined FIR*DFT operator runs
  ~4.3x the minimal FLOPs). Roofline shares against the card's
  published peaks belong to the benchmark (ROADMAP §1.1).
- latency_ms_p50 / p95: wall latency of ONE chain step, each ended by
  block_until_ready.
- card: name and power limit as nvidia-smi reports them.

Run from the repo root: python bench.py
"""

import json
import sys
import time

import numpy as np


def numpy_baseline(x, taps, nbins, iters=2):
    """FFT-overlap-save FIR + batched FFT in numpy (the honest same-host
    baseline: frequency-domain convolution, all channels batched)."""
    c, t, _ = x.shape
    xc = (x[..., 0] + 1j * x[..., 1]).astype(np.complex64)
    h = np.asarray(taps, np.complex64)
    k = len(h)
    L = 4096  # overlap-save block
    step = L - (k - 1)
    H = np.fft.fft(h, L)
    t0 = time.perf_counter()
    for _ in range(iters):
        ext = np.concatenate([np.zeros((c, k - 1), np.complex64), xc], axis=1)
        y = np.empty((c, t), np.complex64)
        for s in range(0, t, step):
            blk = ext[:, s: s + L]
            if blk.shape[1] < L:
                blk = np.pad(blk, ((0, 0), (0, L - blk.shape[1])))
            yb = np.fft.ifft(np.fft.fft(blk, axis=-1) * H, axis=-1)
            n = min(step, t - s)
            y[:, s: s + n] = yb[:, k - 1: k - 1 + n]
        frames = y.reshape(c * (t // nbins), nbins)
        _ = np.fft.fft(frames, axis=-1)
    dt = (time.perf_counter() - t0) / iters
    return c * t / dt


def main():
    import jax
    import jax.numpy as jnp
    from pothoscomms_tpu.core.device import (card_name_and_power_limit,
                                             configure_compile_cache,
                                             require_gpu)
    from pothoscomms_tpu.parallel.chain import fir_fft_chain
    from pothoscomms_tpu.parallel.profiling import chain_flops

    devs = require_gpu()
    configure_compile_cache()
    C, T, K, NBINS = 256, 131072, 64, 1024
    rng = np.random.default_rng(0)
    taps = (rng.normal(size=K) + 1j * rng.normal(size=K)) / K

    run, carry = fir_fft_chain(taps, NBINS, C, T)
    x = jnp.asarray(rng.normal(size=(C, T, 2)).astype(np.float32))
    spec, carry = run(x, carry)  # compile outside the window
    jax.block_until_ready(spec)

    iters = 20
    t0 = time.perf_counter()
    for _ in range(iters):
        spec, carry = run(x, carry)
    jax.block_until_ready(spec)
    dt = (time.perf_counter() - t0) / iters
    assert np.isfinite(float(jnp.sum(spec)))
    samples_per_s = C * T / dt

    lat = []
    for _ in range(iters):
        t1 = time.perf_counter()
        spec, carry = run(x, carry)
        jax.block_until_ready(spec)
        lat.append(time.perf_counter() - t1)
    lat.sort()
    p50 = lat[len(lat) // 2]
    p95 = lat[min(len(lat) - 1, int(len(lat) * 0.95))]

    flops = chain_flops(C, T, K, NBINS)
    base = numpy_baseline(np.asarray(x[:, : T // 16]), taps, NBINS)
    result = {
        "metric": "fir_fft_256ch_throughput",
        "value": round(samples_per_s / 1e6, 2),
        "unit": "Msamples/s",
        "vs_baseline": round(samples_per_s / base, 2),
        "eff_tflops": round(flops["executed_gflop"] / dt / 1e3, 2),
        "latency_ms_p50": round(p50 * 1e3, 3),
        "latency_ms_p95": round(p95 * 1e3, 3),
        "device": devs[0].device_kind,
        "card": card_name_and_power_limit(),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    sys.exit(main())
