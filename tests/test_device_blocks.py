"""Block families on the default device through the streaming runtime
(reference discipline: self-tests run against the real implementation,
SURVEY.md §3.5).

Families: float32 math blocks, FFT block parity (complex float + int16
scaled) against numpy goldens at the reference tolerance, FIR oracle,
fused and compiled chains, the PHY sync search, and the non-f32 dtype
catalog (int16, complex, float64), which computes on the same default
device as everything else.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from pothoscomms_tpu import BlockRegistry, Topology
from pothoscomms_tpu.core.fixtures import CollectorSink, FeederSource


def run_one(block, data, dtype):
    feed = FeederSource(dtype)
    feed.feed_buffer(data)
    sink = CollectorSink(dtype if block.outputs["0"].dtype is None
                         else str(block.outputs["0"].dtype))
    topo = Topology()
    topo.connect(feed, 0, block, 0)
    topo.connect(block, 0, sink, 0)
    topo.commit()
    assert topo.wait_inactive()
    return sink.get_buffer()


# --------------------------------------------------------------------- #
# float32 elementwise math blocks
# --------------------------------------------------------------------- #
def test_scale_block_f32():
    rng = np.random.default_rng(0)
    x = rng.normal(size=4096).astype(np.float32)
    blk = BlockRegistry.make("/comms/scale", "float32")
    blk.set_factor(2.5)
    out = run_one(blk, x, "float32")
    np.testing.assert_allclose(out, x * np.float32(2.5), rtol=1e-6)


def test_arithmetic_add_mul_f32():
    rng = np.random.default_rng(1)
    a = rng.normal(size=4096).astype(np.float32)
    b = rng.normal(size=4096).astype(np.float32)
    for op, expect in (("ADD", a + b), ("MUL", a * b)):
        blk = BlockRegistry.make("/comms/arithmetic", "float32", op)
        fa = FeederSource("float32")
        fa.feed_buffer(a)
        fb = FeederSource("float32")
        fb.feed_buffer(b)
        sink = CollectorSink("float32")
        topo = Topology()
        topo.connect(fa, 0, blk, 0)
        topo.connect(fb, 0, blk, 1)
        topo.connect(blk, 0, sink, 0)
        topo.commit()
        assert topo.wait_inactive()
        np.testing.assert_allclose(sink.get_buffer(), expect, rtol=1e-6)


@pytest.mark.parametrize("path,fn", [
    ("/comms/sqrt", np.sqrt),
    ("/comms/exp", np.exp),
    ("/comms/log", np.log),
    ("/comms/sigmoid", lambda x: 1 / (1 + np.exp(-x))),
    ("/comms/sinc", lambda x: np.where(np.abs(x) < 1e-6, 1.0,
                                       np.sin(x) / np.where(x == 0, 1, x))),
])
def test_unary_float_blocks(path, fn):
    rng = np.random.default_rng(2)
    x = (rng.uniform(0.1, 4.0, size=2048)).astype(np.float32)
    blk = BlockRegistry.make(path, "float32")
    out = run_one(blk, x, "float32")
    np.testing.assert_allclose(out, fn(x.astype(np.float64)), rtol=2e-5,
                               atol=2e-6)


def test_trigonometric_sin_f32():
    rng = np.random.default_rng(3)
    x = rng.uniform(-3, 3, size=2048).astype(np.float32)
    blk = BlockRegistry.make("/comms/trigonometric", "float32", "SIN")
    out = run_one(blk, x, "float32")
    np.testing.assert_allclose(out, np.sin(x), rtol=1e-5, atol=1e-6)


def test_comparator_f32():
    rng = np.random.default_rng(4)
    a = rng.normal(size=2048).astype(np.float32)
    b = rng.normal(size=2048).astype(np.float32)
    blk = BlockRegistry.make("/comms/comparator", "float32", ">")
    fa = FeederSource("float32")
    fa.feed_buffer(a)
    fb = FeederSource("float32")
    fb.feed_buffer(b)
    sink = CollectorSink("int8")
    topo = Topology()
    topo.connect(fa, 0, blk, 0)
    topo.connect(fb, 0, blk, 1)
    topo.connect(blk, 0, sink, 0)
    topo.commit()
    assert topo.wait_inactive()
    np.testing.assert_array_equal(sink.get_buffer(),
                                  (a > b).astype(np.int8))


# --------------------------------------------------------------------- #
# FFT block parity at the reference tolerance (fft/TestFFT.cpp)
# --------------------------------------------------------------------- #
def test_fft_block_parity_c64():
    rng = np.random.default_rng(5)
    nb = 1024
    x = (rng.normal(size=4 * nb) + 1j * rng.normal(size=4 * nb)).astype(
        np.complex64)
    blk = BlockRegistry.make("/comms/fft", "complex_float32", nb, False)
    out = run_one(blk, x, "complex_float32")
    exp = np.fft.fft(x.reshape(4, nb), axis=-1).reshape(-1)
    scale = np.max(np.abs(exp))
    assert np.max(np.abs(out - exp)) / scale < 1e-4  # well inside 0.01


def test_fft_ifft_roundtrip_c64():
    rng = np.random.default_rng(6)
    nb = 512
    x = (rng.normal(size=2 * nb) + 1j * rng.normal(size=2 * nb)).astype(
        np.complex64)
    fwd = BlockRegistry.make("/comms/fft", "complex_float32", nb, False)
    inv = BlockRegistry.make("/comms/fft", "complex_float32", nb, True)
    y = run_one(fwd, x, "complex_float32")
    z = run_one(inv, y.astype(np.complex64), "complex_float32")
    # inverse is unnormalized: round trip gains N (fft/TestFFT.cpp:79-80)
    np.testing.assert_allclose(z / nb, x, atol=2e-3)


def test_fft_block_int16_scaled():
    rng = np.random.default_rng(7)
    nb = 256
    x = np.stack([rng.integers(-3000, 3000, 2 * nb),
                  rng.integers(-3000, 3000, 2 * nb)], -1).astype(np.int16)
    blk = BlockRegistry.make("/comms/fft", "complex_int16", nb, False)
    out = run_one(blk, x, "complex_int16")
    xc = x[..., 0].astype(np.float64) + 1j * x[..., 1].astype(np.float64)
    exp = np.fft.fft(xc.reshape(2, nb), axis=-1).reshape(-1) / nb
    got = out[..., 0].astype(np.float64) + 1j * out[..., 1].astype(np.float64)
    assert np.max(np.abs(got - exp)) <= 1.0  # rounding to int16


# --------------------------------------------------------------------- #
# FIR block + fused chains
# --------------------------------------------------------------------- #
def test_fir_filter_block_f32_oracle():
    rng = np.random.default_rng(8)
    taps = rng.normal(size=33)
    x = rng.normal(size=8192).astype(np.float32)
    blk = BlockRegistry.make("/comms/fir_filter", "float32")
    blk.set_taps(taps)
    out = run_one(blk, x, "float32")
    exp = np.convolve(x.astype(np.float64), taps)[32: 32 + len(out)]
    np.testing.assert_allclose(out, exp.astype(np.float32), atol=1e-4)


def test_fused_fir_fft_chain_oracle():
    from pothoscomms_tpu.parallel.chain import fir_fft_chain

    rng = np.random.default_rng(9)
    C, T, K, NB = 8, 4096, 64, 1024
    taps = (rng.normal(size=K) + 1j * rng.normal(size=K)) / K
    x = rng.normal(size=(C, T, 2)).astype(np.float32)
    run, hist0 = fir_fft_chain(taps, NB, C, T)
    spec, hist = run(jnp.asarray(x), hist0)
    spec = np.asarray(spec)
    xc = x[..., 0] + 1j * x[..., 1]
    y = np.stack([np.convolve(xc[c], taps)[:T] for c in range(C)])
    exp = np.fft.fft(y.reshape(C, T // NB, NB), axis=-1)
    got = spec[..., 0] + 1j * spec[..., 1]
    scale = np.max(np.abs(exp))
    assert np.max(np.abs(got - exp)) / scale < 1e-4
    np.testing.assert_allclose(
        np.asarray(hist), x[:, T - (K - 1):, :], atol=0)


def test_compiled_fm_chain_256ch_oracle():
    """BASELINE config #4 chain (freq_demod -> dc_removal ->
    envelope_detector) fused via compile_chain, vs a numpy oracle."""
    from pothoscomms_tpu.parallel.compiler import compile_chain

    rng = np.random.default_rng(20)
    C, T, D, CASC = 8, 2048, 16, 2
    demod = BlockRegistry.make("/comms/freq_demod", "complex_float32")
    dc = BlockRegistry.make("/comms/dc_removal", "float32")
    dc.set_average_size(D)
    dc.set_cascade_size(CASC)
    env = BlockRegistry.make("/comms/envelope_detector", "float32")
    env.set_attack(10.0)
    env.set_release(40.0)
    step, carry0 = compile_chain([demod, dc, env], channels=C)

    phase = np.cumsum(rng.uniform(-0.5, 0.5, size=(C, T)), axis=1)
    x = np.stack([np.cos(phase), np.sin(phase)], -1).astype(np.float32)
    y, _ = step(jnp.asarray(x), carry0)
    y = np.asarray(y)

    # numpy oracle
    xc = x[..., 0] + 1j * x[..., 1]
    prev = np.concatenate([np.zeros((C, 1), np.complex64), xc[:, :-1]], 1)
    dm = np.angle(xc * np.conj(prev)).astype(np.float32)
    cur = dm
    for s in range(CASC):
        ext = np.concatenate([np.zeros((C, D), np.float32), cur], axis=1)
        cs = np.cumsum(ext, axis=1)
        avg = (cs[:, D:] - cs[:, :-D]) / D
        if s == 0:
            delayed = ext[:, 1: 1 + T]
        cur = avg.astype(np.float32)
    dced = delayed - cur
    ga, gr = np.exp(-1.0 / 10.0), np.exp(-1.0 / 40.0)
    envs = np.zeros(C, np.float64)
    out = np.empty((C, T), np.float64)
    mag = np.abs(dced)
    for t in range(T):
        g = np.where(mag[:, t] > envs, ga, gr)
        envs = g * envs + (1.0 - g) * mag[:, t]
        out[:, t] = envs
    np.testing.assert_allclose(y, out.astype(np.float32), atol=2e-3)


def test_compiled_block_chain_demod():
    """compile_chain over product blocks: freq_demod device core."""
    from pothoscomms_tpu.parallel.compiler import compile_chain

    rng = np.random.default_rng(10)
    C, T = 4, 2048
    demod = BlockRegistry.make("/comms/freq_demod", "complex_float32")
    step, carry0 = compile_chain([demod], channels=C)
    phase = np.cumsum(rng.uniform(-0.5, 0.5, size=(C, T)), axis=1)
    x = np.stack([np.cos(phase), np.sin(phase)], -1).astype(np.float32)
    y, _ = step(jnp.asarray(x), carry0)
    y = np.asarray(y)
    dphase = np.diff(phase, axis=1)
    np.testing.assert_allclose(y[:, 1:], dphase.astype(np.float32),
                               atol=1e-3)


# --------------------------------------------------------------------- #
# PHY sync search on the device
# --------------------------------------------------------------------- #
def test_frame_sync_device_search_detects():
    from pothoscomms_tpu.core.labels import Label

    rng = np.random.default_rng(13)
    payload = rng.integers(0, 2, 30) * 2.0 - 1.0
    insert = BlockRegistry.make("/comms/frame_insert", "complex_float32")
    insert.set_symbol_width(20)
    insert.set_preamble([1.0])
    insert.set_frame_start_id("s")
    up = BlockRegistry.make("/comms/fir_filter", "complex_float32",
                            "COMPLEX")
    up.set_interpolation(4)
    up.set_taps(np.ones(4))
    fs = BlockRegistry.make("/comms/frame_sync", "complex_float32")
    fs.set_preamble([1.0])
    fs.set_symbol_width(20)
    fs.set_data_width(4)
    fs.set_frame_start_id("rxStart")

    sig = np.concatenate([
        np.zeros(30, np.complex64),
        payload.astype(np.complex64),
        np.zeros(120, np.complex64),
    ])
    feed = FeederSource("complex_float32")
    feed.feed_buffer(sig, [Label("s", len(payload), 30, 1)])
    sink = CollectorSink("complex_float32")
    topo = Topology()
    topo.connect(feed, 0, insert, 0)
    topo.connect(insert, 0, up, 0)
    topo.connect(up, 0, fs, 0)
    topo.connect(fs, 0, sink, 0)
    topo.commit()
    assert topo.wait_inactive()
    labels = {lb.id: lb for lb in sink.get_labels()}
    assert "rxStart" in labels
    assert labels["rxStart"].data == len(payload)


def test_dtype_catalog_fallback_in_chip_session():
    """Int/complex/f64 block dtypes compute on the default device with
    full fidelity (no device routing by dtype)."""
    rng = np.random.default_rng(21)
    # int16 arithmetic with wraparound semantics
    a = rng.integers(-30000, 30000, 1024).astype(np.int16)
    b = rng.integers(-30000, 30000, 1024).astype(np.int16)
    blk = BlockRegistry.make("/comms/arithmetic", "int16", "ADD")
    fa = FeederSource("int16")
    fa.feed_buffer(a)
    fb = FeederSource("int16")
    fb.feed_buffer(b)
    sink = CollectorSink("int16")
    topo = Topology()
    topo.connect(fa, 0, blk, 0)
    topo.connect(fb, 0, blk, 1)
    topo.connect(blk, 0, sink, 0)
    topo.commit()
    assert topo.wait_inactive()
    np.testing.assert_array_equal(sink.get_buffer(), a + b)  # wraps

    # complex conjugate
    x = (rng.normal(size=512) + 1j * rng.normal(size=512)).astype(
        np.complex64)
    conj = BlockRegistry.make("/comms/conjugate", "complex_float32")
    out = run_one(conj, x, "complex_float32")
    np.testing.assert_array_equal(out, np.conj(x))

    # int16 FIR with Q-format accumulation
    xi = rng.integers(-1000, 1000, 4096).astype(np.int16)
    fir = BlockRegistry.make("/comms/fir_filter", "int16")
    fir.set_taps([0.5, 0.25, 0.125])
    out = run_one(fir, xi, "int16")
    assert out.dtype == np.int16 and len(out) > 0

    # float64 IIR (spuce-parity double recursion)
    xf = rng.normal(size=2048)
    iir = BlockRegistry.make("/comms/iir_filter", "float64")
    iir.set_taps([0.2, 0.2, 1.0, -0.6])  # b=[0.2,0.2], a=[1,-0.6]
    out = run_one(iir, xf.astype(np.float64), "float64")
    assert np.all(np.isfinite(out)) and len(out) == len(xf)


def test_digital_symbol_stack_roundtrip():
    """bits -> symbols -> bytes -> symbols -> bits identity plus
    scrambler/descrambler and mapper->slicer round trips (streaming
    paths of the digital layer)."""
    rng = np.random.default_rng(30)
    bits = rng.integers(0, 2, 960).astype(np.uint8)

    b2s = BlockRegistry.make("/comms/bits_to_symbols")
    b2s.set_modulus(4)
    s2b = BlockRegistry.make("/comms/symbols_to_bits")
    s2b.set_modulus(4)
    feed = FeederSource("uint8")
    feed.feed_buffer(bits)
    sink = CollectorSink("uint8")
    topo = Topology()
    topo.connect(feed, 0, b2s, 0)
    topo.connect(b2s, 0, s2b, 0)
    topo.connect(s2b, 0, sink, 0)
    topo.commit()
    assert topo.wait_inactive()
    np.testing.assert_array_equal(sink.get_buffer(), bits)

    scr = BlockRegistry.make("/comms/scrambler")
    scr.set_mode("multiplicative")
    scr.set_poly(0x19)
    desc = BlockRegistry.make("/comms/descrambler")
    desc.set_mode("multiplicative")
    desc.set_poly(0x19)
    feed = FeederSource("uint8")
    feed.feed_buffer(bits)
    sink = CollectorSink("uint8")
    topo = Topology()
    topo.connect(feed, 0, scr, 0)
    topo.connect(scr, 0, desc, 0)
    topo.connect(desc, 0, sink, 0)
    topo.commit()
    assert topo.wait_inactive()
    out = sink.get_buffer()
    # multiplicative descrambler self-syncs after the LFSR degree
    np.testing.assert_array_equal(out[8:], bits[8: len(out)])

    qpsk = [1 + 1j, -1 + 1j, -1 - 1j, 1 - 1j]
    mapper = BlockRegistry.make("/comms/symbol_mapper", "complex_float32")
    mapper.set_map(qpsk)
    slicer = BlockRegistry.make("/comms/symbol_slicer", "complex_float32")
    slicer.set_map(qpsk)
    syms = rng.integers(0, 4, 500).astype(np.uint8)
    feed = FeederSource("uint8")
    feed.feed_buffer(syms)
    sink = CollectorSink("uint8")
    topo = Topology()
    topo.connect(feed, 0, mapper, 0)
    topo.connect(mapper, 0, slicer, 0)
    topo.connect(slicer, 0, sink, 0)
    topo.commit()
    assert topo.wait_inactive()
    np.testing.assert_array_equal(sink.get_buffer(), syms)


def test_mac_llc_loopback_in_chip_session():
    """Two full MAC+LLC stacks back to back (reference
    mac/TestSimpleLlc.cpp wiring) deliver bit-exact packets."""
    from pothoscomms_tpu.core.packet import Packet

    rng = np.random.default_rng(31)
    payloads = [rng.integers(0, 256, 64).astype(np.uint8)
                for _ in range(8)]

    llcA = BlockRegistry.make("/comms/simple_llc", 41)
    llcA.set_recipient(0xB)
    llcA.set_port(123)
    llcB = BlockRegistry.make("/comms/simple_llc", 42)
    llcB.set_recipient(0xA)
    llcB.set_port(123)
    macA = BlockRegistry.make("/comms/simple_mac")
    macA.set_mac_id(0xA)
    macB = BlockRegistry.make("/comms/simple_mac")
    macB.set_mac_id(0xB)

    feeder = FeederSource("uint8")
    for p in payloads:
        feeder.feed_packet(Packet(p.copy()))
    sink = CollectorSink("uint8")
    topo = Topology()
    topo.connect(feeder, 0, llcA, "dataIn")
    topo.connect(llcA, "macOut", macA, "macIn")
    topo.connect(macA, "macOut", llcA, "macIn")
    topo.connect(llcB, "dataOut", sink, 0)
    topo.connect(llcB, "macOut", macB, "macIn")
    topo.connect(macB, "macOut", llcB, "macIn")
    topo.connect(macA, "phyOut", macB, "phyIn")
    topo.connect(macB, "phyOut", macA, "phyIn")
    topo.commit()
    assert topo.wait_inactive(timeout=30.0)
    assert macA.get_error_count() == 0
    assert macB.get_error_count() == 0
    got = sink.packets
    assert len(got) == len(payloads)
    for pkt, exp in zip(got, payloads):
        np.testing.assert_array_equal(pkt.payload, exp)


def test_sources_and_probe():
    src = BlockRegistry.make("/comms/waveform_source", "float32")
    src.set_waveform("SINE")
    src.set_frequency(0.01)
    src.set_sample_rate(1.0)
    src.set_amplitude(2.0)
    probe = BlockRegistry.make("/comms/signal_probe", "float32")
    probe.set_mode("RMS")
    topo = Topology()
    topo.connect(src, 0, probe, 0)
    topo.commit()
    topo.run_source_elements(1 << 14)
    assert topo.wait_inactive()
    rms = probe.value()
    assert abs(rms - 2.0 / np.sqrt(2)) < 0.05
