#!/usr/bin/env python3
"""Smoke run of pothoscomms_tpu on one NVIDIA GPU (or four, by option).

Drives the system's main path the way a user builds it, at full width,
and checks every result against a plain numpy reference:

- ``topology``: FeederSource -> /comms/fir_filter (64-tap complex) ->
  /comms/fft (1024) -> CollectorSink through ``Topology``, 4 chunks of
  2^25 complex64 samples. The executor must engage the fused FIR*DFT
  pair at the full 2^25-sample quantum; the spectra are compared with a
  float64 overlap-save FIR + ``np.fft`` over one whole quantum and the
  windows on both sides of every chunk boundary.
- ``chain``: the hand-compiled ``parallel.chain.fir_fft_chain`` at
  C=256, T=131072 against the same reference, with its compile time and
  steady step time beside the step time of XLA's plain version
  (complex64 overlap-save with ``jnp.fft``).
- ``precision``: what Precision.HIGH / HIGHEST compile to for each
  device contraction site (optimized HLO written to chiprun_out/), and
  the measured error of each against float64.
- ``dtypes``: int16 arithmetic, complex64 conjugate, int16 Q-format FIR,
  float64 IIR and complex_int16 FFT, streaming and fused where the block
  fuses, on the GPU (no CPU device scope anywhere).
- ``modem``: the 6-block scrambler -> ... -> descrambler chain as one
  fused segment, bit-exact.

``--four-cards`` runs only the mesh paths (channel-, time- and 2x2
grid-sharded FIR(+FFT) and the channel-sharded digital link) on four
cards, each against its one-card result.

The card's name and power limit print before the results; the last line
of standard output is one JSON object. Any failed check raises, so the
script exits non-zero; without a GPU it exits non-zero before running
anything.

Usage:  python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# The reference's FFT golden contract (fft/TestFFT.cpp:55-56): abs error
# < 0.01 per component, for inputs of the goldens' magnitude (components
# in [-1, 1]). Every float spectrum check below uses that regime.
FFT_TOL = 0.01


def log(*args) -> None:
    print(*args, flush=True)


# --------------------------------------------------------------------- #
# references (numpy, float64; independent of the code under test)
# --------------------------------------------------------------------- #
def ref_fir(x, taps, hist=None, block: int = 4096):
    """Causal FIR y[n] = sum_k h[k] x[n-k] over the last axis of ``x``
    in float64, by overlap-save FFT convolution. ``hist`` holds the K-1
    samples before x[0] (zeros when None)."""
    h = np.asarray(taps, np.complex128)
    k1 = len(h) - 1
    x = np.asarray(x, np.complex128)
    lead = (np.zeros(x.shape[:-1] + (k1,), np.complex128) if hist is None
            else np.asarray(hist, np.complex128))
    ext = np.concatenate([lead, x], axis=-1)
    t = x.shape[-1]
    step = block - k1
    nblk = -(-t // step)
    pad = (nblk - 1) * step + block - ext.shape[-1]
    ext = np.concatenate(
        [ext, np.zeros(x.shape[:-1] + (max(pad, 0),), np.complex128)], -1)
    idx = np.arange(nblk)[:, None] * step + np.arange(block)[None, :]
    frames = ext[..., idx]
    y = np.fft.ifft(np.fft.fft(frames, axis=-1) * np.fft.fft(h, block),
                    axis=-1)[..., k1:]
    return y.reshape(x.shape[:-1] + (-1,))[..., :t]


def ref_spectra(x, taps, nbins, hist=None):
    """float64 FIR then ``np.fft`` over consecutive nbins-windows."""
    y = ref_fir(x, taps, hist)
    return np.fft.fft(y.reshape(y.shape[:-1] + (-1, nbins)), axis=-1)


def max_component_err(got, exp) -> float:
    d = np.asarray(got, np.complex128) - exp
    return float(max(np.max(np.abs(d.real)), np.max(np.abs(d.imag))))


def complex_taps(k: int, seed: int):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=k) + 1j * rng.normal(size=k)) / k


def uniform_complex(rng, shape):
    """complex64 with components uniform in [-1, 1] (the goldens' regime)."""
    v = rng.random(shape + (2,), dtype=np.float32) * 2 - 1
    return v[..., 0] + 1j * v[..., 1]


def matmul_precision() -> str:
    """The precision every device contraction of the package pins."""
    from pothoscomms_tpu.parallel.cplx import PRECISION

    return PRECISION.name


# --------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------- #
def phase_topology(chunk: int = 1 << 25, n_chunks: int = 4, k: int = 64,
                   nbins: int = 1024, seed: int = 0,
                   expect_quantum: int | None = None) -> dict:
    """The user's main path through ``Topology``; see module docstring."""
    import jax.numpy as jnp

    from pothoscomms_tpu import BlockRegistry, Topology
    from pothoscomms_tpu.core.fixtures import CollectorSink, FeederSource
    from pothoscomms_tpu.core.fusion import MAX_QUANTUM, DeviceChunk

    if expect_quantum is None:
        expect_quantum = min(chunk, MAX_QUANTUM)
    taps = complex_taps(k, seed)
    rng = np.random.default_rng(seed + 1)
    fir = BlockRegistry.make("/comms/fir_filter", "complex_float32",
                             "COMPLEX")
    fir.set_taps(taps)
    fft = BlockRegistry.make("/comms/fft", "complex_float32", nbins, False)
    feed = FeederSource("complex_float32")
    sink = CollectorSink("complex_float32")
    topo = Topology()
    topo.connect(feed, 0, fir, 0)
    topo.connect(fir, 0, fft, 0)
    topo.connect(fft, 0, sink, 0)
    fir.input(0).set_capacity(chunk * (n_chunks + 1))
    fft.input(0).set_capacity(chunk * 2)
    sink.input(0).set_capacity(chunk * 2)
    topo.commit()

    xs = [uniform_complex(rng, (chunk,)) for _ in range(n_chunks)]
    # K-1 zero primer: the FIR's history, so the first engage can export
    # it and the pair engages on the first quantum
    feed.feed_buffer(np.zeros(k - 1, np.complex64))
    for x in xs:
        planar = jnp.asarray(np.stack([x.real, x.imag], -1))
        feed.feed_buffer(DeviceChunk(planar, "complex_float32"))
    t0 = time.perf_counter()
    assert topo.wait_inactive(timeout=1800.0), "topology did not quiesce"
    wall = time.perf_counter() - t0
    (seg,) = topo._segments
    assert seg.engage_count >= 1 and seg.fused_elements > 0, \
        "FIR->FFT segment never engaged"
    assert seg.pairs == 1, "the FIR*DFT pair did not engage"
    assert seg.max_quantum == expect_quantum, \
        f"largest fused quantum {seg.max_quantum} != {expect_quantum}"

    out = sink.get_buffer()
    total = chunk * n_chunks
    assert out.shape == (total,), out.shape
    spec = out.reshape(-1, nbins)
    x_all = np.concatenate(xs)
    q = expect_quantum
    errs, peak = [], 0.0
    # one whole quantum from the start of the stream
    exp = ref_spectra(x_all[:q], taps, nbins)
    errs.append(max_component_err(spec[: q // nbins], exp))
    peak = max(peak, float(np.max(np.abs(exp))))
    # the windows on both sides of every chunk boundary
    for b in range(1, n_chunks):
        w0 = b * chunk // nbins - 2
        s0, s1 = w0 * nbins, (w0 + 4) * nbins
        exp = ref_spectra(x_all[s0:s1], taps, nbins,
                          hist=x_all[s0 - (k - 1): s0])
        errs.append(max_component_err(spec[w0: w0 + 4], exp))
        peak = max(peak, float(np.max(np.abs(exp))))
    err = max(errs)
    res = {"max_abs_err": err, "rel_err": err / peak, "tol_abs": FFT_TOL,
           "precision": matmul_precision(),
           "quantum": seg.max_quantum, "engages": seg.engage_count,
           "fused_elements": seg.fused_elements, "wall_s": wall}
    assert np.isfinite(spec).all(), "non-finite spectra"
    assert err < FFT_TOL, f"topology spectra error {err} >= {FFT_TOL}"
    return res


def _plain_fir_fft(nbins: int):
    """XLA's plain version of the chain: complex64 overlap-save FIR with
    ``jnp.fft`` per window (FFT of window + K-1 history, times H, inverse
    FFT), then a ``jnp.fft`` of each window."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def step(x, hist, hfft):
        c, t = x.shape
        k1 = hist.shape[1]
        xw = x.reshape(c, t // nbins, nbins)
        prev = jnp.concatenate([hist[:, None], xw[:, :-1, nbins - k1:]],
                               axis=1)
        a = jnp.concatenate([prev, xw], axis=2)
        n = hfft.shape[-1]
        y = jnp.fft.ifft(jnp.fft.fft(a, n=n, axis=-1) * hfft,
                         axis=-1)[..., k1: k1 + nbins]
        return jnp.fft.fft(y, axis=-1), x[:, t - k1:]

    return step


def _time_steps(fn, x, carry, iters: int) -> float:
    import jax

    out, carry = fn(x, carry)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out, carry = fn(x, carry)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def phase_chain(c: int = 256, t: int = 131072, k: int = 64,
                nbins: int = 1024, iters: int = 20, seed: int = 2) -> dict:
    """Hand-compiled FIR->FFT chain vs the float64 reference, with its
    compile and step times beside XLA's plain version's step time."""
    import jax
    import jax.numpy as jnp

    from pothoscomms_tpu.parallel.chain import fir_fft_chain

    taps = complex_taps(k, seed)
    xc = uniform_complex(np.random.default_rng(seed + 1), (c, t))
    x = jnp.asarray(np.stack([xc.real, xc.imag], -1))
    run, hist0 = fir_fft_chain(taps, nbins, c, t)
    t0 = time.perf_counter()
    spec, _ = run(x, hist0)
    jax.block_until_ready(spec)
    first_call = time.perf_counter() - t0
    step_s = _time_steps(run, x, hist0, iters)
    exp = ref_spectra(xc, taps, nbins)
    got = np.asarray(spec)
    err = max_component_err(got[..., 0] + 1j * got[..., 1], exp)

    plain = _plain_fir_fft(nbins)
    n = 1 << int(np.ceil(np.log2(nbins + k - 1)))
    hfft = jnp.asarray(np.fft.fft(taps, n).astype(np.complex64))
    x64 = jnp.asarray(xc)
    phist = jnp.zeros((c, k - 1), jnp.complex64)
    pspec, _ = plain(x64, phist, hfft)
    perr = max_component_err(np.asarray(pspec), exp)
    plain_s = _time_steps(lambda a, h: plain(a, h, hfft), x64, phist, iters)
    res = {"max_abs_err": err, "rel_err": err / float(np.max(np.abs(exp))),
           "tol_abs": FFT_TOL, "precision": matmul_precision(),
           "first_call_s": first_call, "step_ms": step_s * 1e3,
           "msamp_per_s": c * t / step_s / 1e6,
           "plain_xla_step_ms": plain_s * 1e3,
           "plain_xla_max_abs_err": perr}
    assert err < FFT_TOL, f"chain spectra error {err} >= {FFT_TOL}"
    assert perr < FFT_TOL, f"plain XLA spectra error {perr} >= {FFT_TOL}"
    return res


def _precision_sites():
    """(name, file tag, jitted fn, args, float64 reference) for each
    device contraction site at small real-layout shapes, plus a bare f32
    matmul at HIGH and at HIGHEST for comparison. The package's sites
    run at the precision they pin (``parallel.cplx.PRECISION``)."""
    import jax
    import jax.numpy as jnp

    from pothoscomms_tpu.ops import filter as fops
    from pothoscomms_tpu.parallel import chain, cplx

    rng = np.random.default_rng(5)
    a = rng.random((512, 1024), dtype=np.float32) * 2 - 1
    b = rng.random((1024, 1024), dtype=np.float32) * 2 - 1
    ab = (jnp.asarray(a), jnp.asarray(b))
    ref_mm = a.astype(np.float64) @ b.astype(np.float64)

    def mm(precision):
        return jax.jit(lambda p, q: jnp.matmul(
            p, q, preferred_element_type=jnp.float32, precision=precision))

    k, nbins, c, t = 64, 1024, 4, 8192
    taps = complex_taps(k, 6)
    xc = uniform_complex(rng, (c, t))
    xp = jnp.asarray(np.stack([xc.real, xc.imag], -1))
    (g0r, g0i), (g1r, g1i) = chain.combined_fir_fft_operators(taps, nbins,
                                                             128)
    hist = jnp.zeros((c, k - 1, 2), jnp.float32)
    pair = jax.jit(lambda x, h: chain.fir_fft_combined_step(
        x, h, g0r, g0i, g0r + g0i, g1r, g1i, g1r + g1i, nbins, k, 128)[0])
    t0m, t1m = chain.fir_toeplitz_matrices(taps)
    toe = jax.jit(lambda x, h: chain.fir_multichannel_mm(x, h, t0m, t1m)[0])
    dft = np.fft.fft(np.eye(256))
    cm = jax.jit(lambda x: cplx.matmul(x, dft.real.astype(np.float32),
                                       dft.imag.astype(np.float32)))
    rt0, rt1, b_in, b_out = fops.rational_fir_operators(taps, 3, 2)
    rhist = jnp.zeros((c, rt1.shape[0], 2), jnp.float32)
    nr = (t // b_in) * b_in
    rat = jax.jit(lambda x, h: fops.rational_fir_mm(
        x[:, :nr], h, rt0, rt1, b_in, b_out)[0])
    # L=2 / M=3: upsample by zero insertion, filter, keep every 3rd
    xu = np.zeros((c, 2 * nr), np.complex128)
    xu[:, ::2] = xc[:, :nr]
    return [
        ("jnp.matmul f32 [512,1024]x[1024,1024] HIGH", "matmul_HIGH",
         mm(jax.lax.Precision.HIGH), ab, ref_mm),
        ("jnp.matmul f32 [512,1024]x[1024,1024] HIGHEST", "matmul_HIGHEST",
         mm(jax.lax.Precision.HIGHEST), ab, ref_mm),
        ("pair step chain.fir_fft_combined_step", "pair", pair, (xp, hist),
         ref_spectra(xc, taps, nbins)),
        ("Toeplitz FIR chain.fir_multichannel_mm", "toeplitz", toe,
         (xp, hist), ref_fir(xc, taps)),
        ("cplx.matmul (256-pt DFT)", "cplx_matmul", cm,
         (xp.reshape(-1, 256, 2),), np.fft.fft(xc.reshape(-1, 256))),
        ("rational FIR ops.filter.rational_fir_mm (3:2)", "rational", rat,
         (xp, rhist), ref_fir(xu, taps)[:, 2::3]),
    ]


def _hlo_dot_summary(text: str) -> list:
    """The lines of an optimized HLO module that carry out a matrix
    product, cut to the fields that name its emitter and precision."""
    import re

    keep = []
    for line in text.splitlines():
        if not re.search(r"custom_call_target=|__triton_gemm|\bdot\(|"
                         r"cublas|convolution\(", line):
            continue
        fields = re.findall(
            r'custom_call_target="[^"]+"|"kind":"[^"]+"|'
            r'operand_precision[^\]}]*[\]}]|algorithm[=":]+[A-Za-z0-9_]+|'
            r'"compute_type":"[^"]+"|\bdot\(|convolution\(', line)
        if fields:
            keep.append(" ".join(dict.fromkeys(fields)))
    return sorted(set(keep))


def phase_precision(out_dir: Path = OUT_DIR) -> dict:
    """What each contraction site compiles to (optimized HLO written to
    ``out_dir``) and its measured error against float64."""
    res = {}
    out_dir.mkdir(exist_ok=True)
    for name, tag, fn, args, ref in _precision_sites():
        text = fn.lower(*args).compile().as_text()
        (out_dir / f"hlo_{tag}.txt").write_text(text)
        got = np.asarray(fn(*args))
        if np.iscomplexobj(ref):  # planar [..., 2] -> complex
            got = got[..., 0] + 1j * got[..., 1]
        d = np.abs(got - ref)
        res[name] = {"hlo": _hlo_dot_summary(text),
                     "max_abs_err": float(d.max()),
                     "rel_err": float(d.max() / np.abs(ref).max())}
    return res


def _run_chain(blocks, feeds, out_dtype, fuse: bool, threshold=1 << 16):
    from pothoscomms_tpu import Topology
    from pothoscomms_tpu.core.fixtures import CollectorSink, FeederSource

    topo = Topology()
    topo.auto_fuse = fuse
    topo.fuse_threshold = threshold
    sink = CollectorSink(out_dtype)
    head = blocks[0]
    srcs = []
    for i, (dt, data) in enumerate(feeds):
        f = FeederSource(dt)
        f.feed_buffer(data)
        topo.connect(f, 0, head, i)
        srcs.append(f)
    for a, b in zip(blocks[:-1], blocks[1:]):
        topo.connect(a, 0, b, 0)
    topo.connect(blocks[-1], 0, sink, 0)
    topo.commit()
    assert topo.wait_inactive(timeout=600.0), "topology did not quiesce"
    fused = sum(s.fused_elements for s in topo._segments)
    return sink.get_buffer(), fused


def _no_device_scope():
    """Context in which entering any ``jax.default_device`` scope
    raises, so a kernel routed off the default (GPU) device fails."""
    import contextlib

    import jax

    @contextlib.contextmanager
    def guard():
        orig = jax.default_device

        def refuse(*a, **k):
            raise AssertionError("a default_device scope was entered")

        jax.default_device = refuse
        try:
            yield
        finally:
            jax.default_device = orig

    return guard()


def phase_dtypes(n: int = 1 << 18, nbins: int = 1024, seed: int = 3,
                 threshold: int = 1 << 16) -> dict:
    """Non-f32 dtypes on the default device, each against its oracle."""
    import jax
    import scipy.signal

    from pothoscomms_tpu import BlockRegistry
    from pothoscomms_tpu.core.testing import from_complex_int

    assert jax.config.jax_default_device is None
    rng = np.random.default_rng(seed)
    res = {}
    with _no_device_scope():
        # int16 arithmetic: two's-complement wraparound (streams only)
        a = rng.integers(-30000, 30000, n).astype(np.int16)
        b = rng.integers(-30000, 30000, n).astype(np.int16)
        out, _ = _run_chain(
            [BlockRegistry.make("/comms/arithmetic", "int16", "ADD")],
            [("int16", a), ("int16", b)], "int16", fuse=False)
        assert np.array_equal(out, a + b), "int16 ADD mismatch"
        res["int16_arithmetic"] = "exact"

        # complex64 conjugate, streaming and fused (conjugate -> scale 2)
        x = uniform_complex(rng, (n,)).astype(np.complex64)

        def conj_chain():
            s = BlockRegistry.make("/comms/scale", "complex_float32")
            s.set_factor(2.0)
            return [BlockRegistry.make("/comms/conjugate",
                                       "complex_float32"), s]

        exp = 2 * np.conj(x)
        for fuse in (False, True):
            out, fused = _run_chain(conj_chain(), [("complex_float32", x)],
                                    "complex_float32", fuse, threshold)
            assert (fused > 0) == fuse
            assert np.array_equal(out, exp), f"conjugate fuse={fuse}"
        res["complex64_conjugate"] = "exact (streaming, fused)"

        # int16 Q-format FIR (streams only: exact Q accumulators)
        xi = rng.integers(-1000, 1000, n).astype(np.int16)
        taps = [0.5, 0.25, 0.125]
        fir = BlockRegistry.make("/comms/fir_filter", "int16")
        fir.set_taps(taps)
        out, _ = _run_chain([fir], [("int16", xi)], "int16", fuse=False)
        # Q16 taps (int32 accumulator, shift 16), reference
        # filter/FIRFilter.cpp: y = (sum_k q(h_k) x[n-k]) >> 16
        q = np.trunc(np.asarray(taps) * 65536).astype(np.int64)
        acc = np.convolve(xi.astype(np.int64), q)[len(taps) - 1: n]
        exp = (acc >> 16).astype(np.int16)
        assert np.array_equal(out, exp), "int16 Q-format FIR mismatch"
        res["int16_qformat_fir"] = "exact"

        # float64 IIR: per-sample lax.scan on the device (streams only)
        xf = rng.normal(size=n)
        iir = BlockRegistry.make("/comms/iir_filter", "float64")
        iir.set_taps([0.2, 0.2, 1.0, -0.6])
        t0 = time.perf_counter()
        out, _ = _run_chain([iir], [("float64", xf)], "float64", fuse=False)
        wall = time.perf_counter() - t0
        exp = scipy.signal.lfilter([0.2, 0.2], [1.0, -0.6], xf)
        err = float(np.max(np.abs(out - exp)))
        assert err < 1e-12, f"float64 IIR error {err}"
        res["float64_iir"] = {"max_abs_err": err, "tol_abs": 1e-12,
                              "samples": n, "wall_s": wall}

        # complex_int16 FFT: kiss FIXED_POINT contract (1/N, rounded),
        # streaming and fused (byte_order swap twice -> fft)
        xs = rng.integers(-3000, 3000, (n, 2)).astype(np.int16)
        xc = xs[..., 0].astype(np.float64) + 1j * xs[..., 1]
        exp = np.fft.fft(xc.reshape(-1, nbins), axis=-1).reshape(-1) / nbins

        def fft_chain():
            blocks = []
            for _ in range(2):
                bo = BlockRegistry.make("/comms/byte_order", "complex_int16")
                bo.set_byte_order("Swap Order")
                blocks.append(bo)
            return blocks + [BlockRegistry.make(
                "/comms/fft", "complex_int16", nbins, False)]

        outs = []
        for fuse in (False, True):
            out, fused = _run_chain(fft_chain(), [("complex_int16", xs)],
                                    "complex_int16", fuse, threshold)
            assert (fused > 0) == fuse
            e = float(np.max(np.abs(from_complex_int(out) - exp)))
            assert e <= 1.0, f"int16 FFT fuse={fuse} error {e} LSB"
            outs.append(out)
        mism = int(np.sum(outs[0] != outs[1]))
        res["complex_int16_fft"] = {"max_lsb_err": 1.0,
                                    "fused_vs_streaming_mismatches": mism}
    return res


def phase_modem(n_bits: int = 1 << 20, seed: int = 4,
                threshold: int = 1 << 16) -> dict:
    """scrambler -> bits_to_symbols -> mapper -> slicer ->
    symbols_to_bits -> descrambler, one fused segment, bit-exact."""
    from pothoscomms_tpu import BlockRegistry

    table = np.array([1 + 1j, -1 + 1j, -1 - 1j, 1 - 1j]) / np.sqrt(2)

    def blocks():
        s = BlockRegistry.make("/comms/scrambler")
        s.set_mode("additive")
        s.set_poly(0x8E)
        b2s = BlockRegistry.make("/comms/bits_to_symbols", 2, "MSBit")
        m = BlockRegistry.make("/comms/symbol_mapper", "complex_float32")
        m.set_map(table)
        sl = BlockRegistry.make("/comms/symbol_slicer", "complex_float32")
        sl.set_map(table)
        s2b = BlockRegistry.make("/comms/symbols_to_bits", 2, "MSBit")
        d = BlockRegistry.make("/comms/descrambler")
        d.set_mode("additive")
        d.set_poly(0x8E)
        return [s, b2s, m, sl, s2b, d]

    bits = np.random.default_rng(seed).integers(0, 2, n_bits).astype(
        np.uint8)
    out, fused = _run_chain(blocks(), [("uint8", bits)], "uint8", True,
                            threshold)
    assert fused > 0, "modem segment never engaged"
    assert np.array_equal(out, bits), "modem chain is not bit-exact"
    return {"bits": n_bits, "fused_elements": fused, "bit_exact": True}


def phase_four_cards(c: int = 256, t: int = 131072, k: int = 64,
                     nbins: int = 1024, n_dev: int = 4,
                     link_channels: int = 64) -> dict:
    """Mesh paths on ``n_dev`` devices, each against its one-device
    result on the same data."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from pothoscomms_tpu.parallel import cplx
    from pothoscomms_tpu.parallel.chain import (complex_fir_kernel,
                                                fir_fft_chain,
                                                fir_multichannel)
    from pothoscomms_tpu.parallel.link import (apply_channel,
                                               make_sharded_search,
                                               run_sharded_link,
                                               tx_waveform)
    from pothoscomms_tpu.parallel.mesh import (channel_sharded_fir_fft,
                                               grid_sharded_fir, make_mesh,
                                               time_sharded_fir)

    assert len(jax.devices()) >= n_dev, f"needs {n_dev} devices"
    res = {}
    taps = complex_taps(k, 7)
    xc = uniform_complex(np.random.default_rng(8), (c, t))
    x = jnp.asarray(np.stack([xc.real, xc.imag], -1))

    # channel sharding: C/n channels per card, no collectives
    run1, h1 = fir_fft_chain(taps, nbins, c, t)
    one = np.asarray(run1(x, h1)[0])
    mesh = make_mesh(n_dev, "ch")
    run4, init = channel_sharded_fir_fft(mesh, taps, nbins)
    with mesh:
        four = np.asarray(run4(x, init(c))[0])
    d = float(np.max(np.abs(four - one)))
    # same per-channel program; only the batch each card sees differs
    assert d < 1e-4, f"channel-sharded differs from one card by {d}"
    res["channel_sharded_fir_fft"] = {"max_abs_diff_vs_1card": d,
                                      "tol": 1e-4}

    # time sharding: K-1 halos by ppermute
    kern = complex_fir_kernel(taps)
    hist = jnp.zeros((c, k - 1, 2), jnp.float32)
    y1 = np.asarray(fir_multichannel(x, hist, kern, 1)[0])
    mesh_t = make_mesh(n_dev, "t")
    with mesh_t:
        y4 = np.asarray(time_sharded_fir(mesh_t, taps)(x, hist)[0])
    d = float(np.max(np.abs(y4 - y1)))
    assert d < 1e-4, f"time-sharded differs from one card by {d}"
    res["time_sharded_fir"] = {"max_abs_diff_vs_1card": d, "tol": 1e-4}

    # 2x2 [ch, t] grid
    mesh2 = Mesh(np.asarray(jax.devices()[:n_dev]).reshape(2, n_dev // 2),
                 ("ch", "t"))
    with mesh2:
        y22 = np.asarray(grid_sharded_fir(mesh2, taps)(x, hist)[0])
    d = float(np.max(np.abs(y22 - y1)))
    assert d < 1e-4, f"grid-sharded differs from one card by {d}"
    res["grid_sharded_fir_2x2"] = {"max_abs_diff_vs_1card": d, "tol": 1e-4}

    # channel-sharded digital link: bit-exact, and the sharded search
    # equals the one-card search bit for bit
    link = run_sharded_link(make_mesh(n_dev, "ch"), link_channels,
                            n_bits=64, seed=7)
    assert link["all_exact"], "sharded link is not bit-exact"
    bits = np.random.default_rng(5).integers(0, 2, 32).astype(np.uint8)
    wave = apply_channel(tx_waveform(bits), attenuation=0.6, phase=0.4,
                         freq_offset=5e-5)
    cs = 4 * n_dev
    s4, lp, _ = make_sharded_search(make_mesh(n_dev, "ch"), [1.0], 20, 4,
                                    0.01, len(wave))
    s1, _, _ = make_sharded_search(Mesh(np.asarray(jax.devices()[:1]),
                                        ("ch",)), [1.0], 20, 4, 0.01,
                                   len(wave))
    xs = np.zeros((cs, lp, 2), np.float32)
    for i in range(cs):
        xs[i, : len(wave)] = cplx.to_planar(wave * (0.8 + 0.05 * i))
    for v4, v1 in zip(s4(jnp.asarray(xs)), s1(jnp.asarray(xs))):
        assert np.array_equal(np.asarray(v4), np.asarray(v1)), \
            "sharded search differs from one card"
    res["sharded_digital_link"] = {"channels": link_channels,
                                   "bit_exact": True,
                                   "search_equals_1card": True}
    return res


# --------------------------------------------------------------------- #
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the mesh paths, on four cards")
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import jax

    from pothoscomms_tpu.core.device import (card_name_and_power_limit,
                                             configure_compile_cache,
                                             require_gpu)

    try:
        devs = require_gpu()
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    log("compile cache:", configure_compile_cache())
    log("card:", card_name_and_power_limit())
    log("jax", jax.__version__, "devices:", len(devs), devs[0].device_kind)

    if args.four_cards:
        phases = [("four_cards", phase_four_cards)]
    else:
        phases = [("precision", phase_precision),
                  ("topology", phase_topology),
                  ("chain", phase_chain),
                  ("dtypes", phase_dtypes),
                  ("modem", phase_modem)]
    for name, fn in phases:
        t0 = time.perf_counter()
        res = fn()
        log(f"phase {name} ok ({time.perf_counter() - t0:.1f} s):",
            json.dumps(res))
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
