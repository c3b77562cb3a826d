"""Filter block tests.

Mirrors reference tests filter/TestFIRFilter.cpp (tone-RMS matrix over
decim x interp x dtype), filter/TestFIRDesigner.cpp (frequency-domain
band-power matrix), filter/TestIIRFilter.cpp (smoke + recursion), plus
oracle-exact checks of the polyphase/Q-format hot loop, burst flushing,
DC removal, and the envelope follower.
"""

import numpy as np
import pytest

from pothoscomms_tpu import BlockRegistry, Label, Topology
from pothoscomms_tpu.core.dtypes import DType
from pothoscomms_tpu.core.fixtures import CollectorSink, FeederSource
from pothoscomms_tpu.core.qformat import Q_ACCUMULATOR
from pothoscomms_tpu.core.testing import (
    assert_buffers_close,
    assert_buffers_equal,
    from_complex_int,
    to_complex_int,
)


# ---------------------------------------------------------------------- #
# Oracle: direct scalar port of the reference polyphase loop
# (filter/FIRFilter.cpp:278-302 + updateInternals :327-354)
# ---------------------------------------------------------------------- #
def fir_oracle(x, taps, M, L, dtype_name, complex_taps=False):
    """Run the reference FIR semantics over a single feed of x.

    Returns the concatenated outputs of repeated work() calls (history
    carried in the buffer, K-1 samples always left queued).
    """
    dt = DType.parse(dtype_name)
    n_taps = len(taps)
    K = n_taps // L + (0 if n_taps % L == 0 else 1)

    if dt.is_float:
        qtaps = [
            [complex(taps[j + k * L]) if complex_taps else float(taps[j + k * L])
             for k in range(K) if j + k * L < n_taps]
            for j in range(L)
        ]

        def q_of(v):
            return v

        def from_q(acc):
            return acc
    else:
        qname = Q_ACCUMULATOR[dt.scalar.name]
        qbits = DType.parse(qname).bits
        shift = qbits // 2
        mod = 1 << qbits

        def wrap(v):
            v = int(v) & (mod - 1)
            return v - mod if v >= (mod >> 1) else v

        def f2q(v):
            return wrap(np.trunc(v * (2.0 ** shift)))

        if complex_taps:
            qtaps = [
                [(f2q(taps[j + k * L].real), f2q(taps[j + k * L].imag))
                 for k in range(K) if j + k * L < n_taps]
                for j in range(L)
            ]
        else:
            qtaps = [
                [f2q(taps[j + k * L]) for k in range(K) if j + k * L < n_taps]
                for j in range(L)
            ]

    S = len(x)
    total_N = ((S - (K - 1)) // M) * M if S >= K else 0
    if total_N <= 0:
        return []
    out = []
    decim = M
    for n in range(total_N):
        for j in range(L):
            decim -= 1
            if decim != 0:
                continue
            decim = M
            if dt.is_float:
                acc = 0j if (dt.is_complex or complex_taps) else 0.0
                for k, t in enumerate(qtaps[j]):
                    acc += t * complex(x[K - 1 + n - k]) if dt.is_complex \
                        else t * x[K - 1 + n - k]
                out.append(acc)
            else:
                qname = Q_ACCUMULATOR[dt.scalar.name]
                qbits = DType.parse(qname).bits
                shift = qbits // 2
                mod = 1 << qbits

                def wrap(v):
                    v = int(v) & (mod - 1)
                    return v - mod if v >= (mod >> 1) else v

                if dt.is_complex:
                    ar = ai = 0
                    for k, t in enumerate(qtaps[j]):
                        xr, xi = int(x[K - 1 + n - k].real), int(x[K - 1 + n - k].imag)
                        if complex_taps:
                            tr, ti = t
                            ar = wrap(ar + wrap(tr * xr) - wrap(ti * xi))
                            ai = wrap(ai + wrap(tr * xi) + wrap(ti * xr))
                        else:
                            ar = wrap(ar + wrap(t * xr))
                            ai = wrap(ai + wrap(t * xi))
                    out.append(complex(ar >> shift, ai >> shift))
                else:
                    acc = 0
                    for k, t in enumerate(qtaps[j]):
                        acc = wrap(acc + wrap(t * int(x[K - 1 + n - k])))
                    out.append(acc >> shift)
    return out


def run_fir(dtype_name, data, taps, M=1, L=1, complex_taps=False, labels=None,
            frame_start="", frame_end=""):
    dt = DType.parse(dtype_name)
    feed = FeederSource(dtype_name)
    feed.feed_buffer(data, labels)
    fir = BlockRegistry.make(
        "/comms/fir_filter", dtype_name,
        "COMPLEX" if complex_taps else "REAL",
    )
    fir.set_taps(taps)
    fir.set_decimation(M)
    fir.set_interpolation(L)
    if frame_start:
        fir.set_frame_start_id(frame_start)
    if frame_end:
        fir.set_frame_end_id(frame_end)
    sink = CollectorSink(dtype_name)
    topo = Topology()
    topo.connect(feed, 0, fir, 0)
    topo.connect(fir, 0, sink, 0)
    topo.commit()
    assert topo.wait_inactive()
    return sink, fir


def test_fir_identity_passthrough():
    x = np.arange(100, dtype=np.float32)
    sink, _ = run_fir("float32", x, [1.0])
    assert_buffers_equal(x, sink.get_buffer())


@pytest.mark.parametrize("M,L", [(1, 1), (2, 1), (1, 2), (3, 2), (2, 3)])
def test_fir_float_oracle(M, L):
    rng = np.random.default_rng(5)
    x = rng.normal(size=257).astype(np.float64)
    taps = rng.normal(size=11)
    sink, _ = run_fir("float64", x, taps, M, L)
    exp = np.array(fir_oracle(x, taps, M, L, "float64"))
    assert_buffers_close(exp, sink.get_buffer(), 1e-9)


@pytest.mark.parametrize("M,L", [(1, 1), (2, 3)])
def test_fir_complex_float_real_taps(M, L):
    rng = np.random.default_rng(6)
    x = (rng.normal(size=130) + 1j * rng.normal(size=130)).astype(np.complex128)
    taps = rng.normal(size=7)
    sink, _ = run_fir("complex_float64", x, taps, M, L)
    exp = np.array(fir_oracle(x, taps, M, L, "complex_float64"))
    assert_buffers_close(exp, sink.get_buffer(), 1e-9)


def test_fir_complex_taps_complex_data():
    rng = np.random.default_rng(7)
    x = (rng.normal(size=120) + 1j * rng.normal(size=120)).astype(np.complex128)
    taps = rng.normal(size=9) + 1j * rng.normal(size=9)
    sink, _ = run_fir("complex_float64", x, taps, 1, 1, complex_taps=True)
    exp = np.array(
        fir_oracle(x, taps, 1, 1, "complex_float64", complex_taps=True)
    )
    assert_buffers_close(exp, sink.get_buffer(), 1e-9)


@pytest.mark.parametrize("M,L", [(1, 1), (2, 1), (1, 3)])
def test_fir_int16_qformat_exact(M, L):
    rng = np.random.default_rng(8)
    x = rng.integers(-1000, 1000, 150).astype(np.int16)
    taps = rng.normal(size=8) * 0.5
    sink, _ = run_fir("int16", x, taps, M, L)
    exp = np.array(fir_oracle(x, taps, M, L, "int16"), np.int16)
    assert_buffers_equal(exp, sink.get_buffer())


def test_fir_complex_int16_real_taps_exact():
    rng = np.random.default_rng(9)
    vals = rng.integers(-500, 500, 90) + 1j * rng.integers(-500, 500, 90)
    x = to_complex_int(vals, "complex_int16")
    taps = rng.normal(size=5)
    sink, _ = run_fir("complex_int16", x, taps)
    exp = np.array(fir_oracle(vals, taps, 1, 1, "complex_int16"))
    got = from_complex_int(sink.get_buffer())
    assert_buffers_equal(exp, got)


def test_fir_complex_int16_complex_taps_exact():
    rng = np.random.default_rng(10)
    vals = rng.integers(-300, 300, 80) + 1j * rng.integers(-300, 300, 80)
    x = to_complex_int(vals, "complex_int16")
    taps = (rng.normal(size=5) + 1j * rng.normal(size=5)) * 0.3
    sink, _ = run_fir("complex_int16", x, taps, complex_taps=True)
    exp = np.array(
        fir_oracle(vals, taps, 1, 1, "complex_int16", complex_taps=True)
    )
    got = from_complex_int(sink.get_buffer())
    assert_buffers_equal(exp, got)


def test_fir_history_carry_across_works():
    # feed in two chunks: output must equal the single-feed oracle over
    # the concatenation (history carried in the port queue)
    rng = np.random.default_rng(11)
    x = rng.normal(size=200).astype(np.float64)
    taps = rng.normal(size=15)
    feed = FeederSource("float64")
    feed.feed_buffer(x[:90])
    feed.feed_buffer(x[90:])
    fir = BlockRegistry.make("/comms/fir_filter", "float64", "REAL")
    fir.set_taps(taps)
    sink = CollectorSink("float64")
    topo = Topology()
    topo.connect(feed, 0, fir, 0)
    topo.connect(fir, 0, sink, 0)
    topo.commit()
    assert topo.wait_inactive()
    exp = np.array(fir_oracle(x, taps, 1, 1, "float64"))
    assert_buffers_close(exp, sink.get_buffer(), 1e-9)


def test_fir_label_rescale():
    x = np.ones(64, np.float64)
    labels = [Label("mark", None, 20), Label("rxRate", 1000.0, 0)]
    sink, _ = run_fir("float64", x, [1.0, 0.0], 2, 1, labels=labels)
    got = {lb.id: lb for lb in sink.get_labels()}
    assert got["mark"].index == 10  # index * L / M
    assert got["rxRate"].data == 500.0  # rate * L / M


def test_fir_burst_flush():
    # a frameStart label bounds the burst; the tail is zero-flushed
    # without consuming the following samples
    rng = np.random.default_rng(12)
    burst_len = 40
    taps = rng.normal(size=9)
    K = len(taps)
    x = rng.normal(size=burst_len).astype(np.float64)
    follow = rng.normal(size=30).astype(np.float64)
    data = np.concatenate([x, follow])
    labels = [Label("frameStart", burst_len, 0)]
    feed = FeederSource("float64")
    feed.feed_buffer(data, labels)
    fir = BlockRegistry.make("/comms/fir_filter", "float64", "REAL")
    fir.set_taps(taps)
    fir.set_frame_start_id("frameStart")
    sink = CollectorSink("float64")
    topo = Topology()
    topo.connect(feed, 0, fir, 0)
    topo.connect(fir, 0, sink, 0)
    topo.commit()
    assert topo.wait_inactive()
    out = sink.get_buffer()
    # expected: full burst convolved with zero tail = oracle over
    # [x, zeros(K-1)], then the following samples begin a fresh stream
    padded = np.concatenate([x, np.zeros(K - 1)])
    exp_burst = np.array(fir_oracle(padded, taps, 1, 1, "float64"))
    exp_follow = np.array(fir_oracle(follow, taps, 1, 1, "float64"))
    exp = np.concatenate([exp_burst, exp_follow])
    assert_buffers_close(exp, out, 1e-9)


def test_fir_wait_taps_gates_until_set():
    x = np.ones(32, np.float32)
    feed = FeederSource("float32")
    feed.feed_buffer(x)
    fir = BlockRegistry.make("/comms/fir_filter", "float32", "REAL")
    fir.set_wait_taps(True)
    sink = CollectorSink("float32")
    topo = Topology()
    topo.connect(feed, 0, fir, 0)
    topo.connect(fir, 0, sink, 0)
    topo.commit()
    assert topo.wait_inactive()
    assert sink.get_buffer().shape[0] == 0  # gated
    fir.set_taps([2.0])  # slot call un-arms the gate
    assert topo.wait_inactive()
    assert_buffers_equal(x * 2.0, sink.get_buffer())


def test_fir_validation():
    fir = BlockRegistry.make("/comms/fir_filter", "float32", "REAL")
    with pytest.raises(ValueError):
        fir.set_taps([])
    with pytest.raises(ValueError):
        fir.set_decimation(0)
    with pytest.raises(ValueError):
        fir.set_interpolation(0)
    with pytest.raises(ValueError):
        BlockRegistry.make("/comms/fir_filter", "float32", "COMPLEX")


# ---------------------------------------------------------------------- #
# Tone-RMS matrix (reference: filter/TestFIRFilter.cpp)
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype_name", ["complex_float64", "complex_int16"])
def test_fir_filter_tone_rms(dtype_name):
    amplitude, rate, freq = 1000.0, 1e6, 30e3
    for decim in (1, 2, 3):
        for interp in (1, 2, 3):
            src = BlockRegistry.make("/comms/waveform_source", dtype_name)
            src.set_amplitude(amplitude)
            src.set_waveform("SINE")
            src.set_frequency(freq)
            src.set_sample_rate(rate)
            release = BlockRegistry.make("/blocks/finite_release")
            release.set_total_elements(4096)
            fir = BlockRegistry.make("/comms/fir_filter", dtype_name, "COMPLEX")
            fir.set_decimation(decim)
            fir.set_interpolation(interp)
            fir.set_wait_taps(True)
            designer = BlockRegistry.make("/comms/fir_designer")
            designer.set_sample_rate(rate * interp / decim)
            designer.set_filter_type("SINC")
            designer.set_band_type("COMPLEX_BAND_PASS")
            designer.set_frequency_lower(freq - 0.1 * rate)
            designer.set_frequency_upper(freq + 0.1 * rate)
            designer.set_bandwidth_trans(freq + 0.1 * rate)
            designer.set_num_taps(101)
            probe = BlockRegistry.make("/comms/signal_probe", dtype_name)
            probe.set_mode("RMS")
            topo = Topology()
            topo.connect(designer, "tapsChanged", fir, "setTaps")
            topo.connect(src, 0, release, 0)
            topo.connect(release, 0, fir, 0)
            topo.connect(fir, 0, probe, 0)
            topo.run_source_elements(4096)
            rms = probe.value()
            assert rms > 0.1 * amplitude, (
                f"{dtype_name} decim={decim} interp={interp}: rms={rms}"
            )


# ---------------------------------------------------------------------- #
# FIR designer frequency-response matrix
# (reference: filter/TestFIRDesigner.cpp:237-274)
# ---------------------------------------------------------------------- #
def _power_bins(taps, fft_size=1024):
    h = np.zeros(fft_size, np.complex128)
    h[: len(taps)] = taps
    H = np.fft.fftshift(np.fft.fft(h))
    return 20 * np.log10(np.abs(H) + 1e-300)


def _bin_at(fft_size, samp_rate, freq):
    return int(fft_size * ((freq + samp_rate / 2) / samp_rate))


PASS, STOP = True, False


def _band_points(band, fs, fl, fu):
    if band == "LOW_PASS":
        return [(STOP, -(fl + fs / 2) / 2), (PASS, 0.0), (STOP, (fl + fs / 2) / 2)]
    if band == "HIGH_PASS":
        return [(PASS, -(fl + fs / 2) / 2), (STOP, 0.0), (PASS, (fl + fs / 2) / 2)]
    if band == "BAND_PASS":
        return [(STOP, -(fu + fs / 2) / 2), (PASS, -(fl + fu) / 2), (STOP, 0.0),
                (PASS, (fl + fu) / 2), (STOP, (fu + fs / 2) / 2)]
    if band == "BAND_STOP":
        return [(PASS, -(fu + fs / 2) / 2), (STOP, -(fl + fu) / 2), (PASS, 0.0),
                (STOP, (fl + fu) / 2), (PASS, (fu + fs / 2) / 2)]
    if band == "COMPLEX_BAND_PASS":
        return [(STOP, (fl - fs / 2) / 2), (PASS, (fl + fu) / 2),
                (STOP, (fu + fs / 2) / 2)]
    if band == "COMPLEX_BAND_STOP":
        return [(PASS, (fl - fs / 2) / 2), (STOP, (fl + fu) / 2),
                (PASS, (fu + fs / 2) / 2)]
    raise ValueError(band)


def test_fir_designer_matrix():
    fs, fl, fu = 1e6, 1.5e5, 3.0e5
    filter_types = ["SINC", "MAXFLAT", "GAUSSIAN", "REMEZ",
                    "ROOT_RAISED_COSINE", "RAISED_COSINE"]
    band_types = ["LOW_PASS", "HIGH_PASS", "BAND_PASS", "BAND_STOP",
                  "COMPLEX_BAND_PASS", "COMPLEX_BAND_STOP"]
    for ftype in filter_types:
        for band in band_types:
            is_stop = "STOP" in band
            is_high = "HIGH" in band
            # same exclusions as the reference matrix (:263-270)
            if ftype == "MAXFLAT" and is_stop:
                continue
            if ftype == "GAUSSIAN":
                continue
            if ftype in ("RAISED_COSINE", "ROOT_RAISED_COSINE") and (
                    is_stop or is_high):
                continue

            designer = BlockRegistry.make("/comms/fir_designer")
            captured = {}

            class _Catch:
                def __init__(self):
                    self.name = "catcher"

                def call(self, name, *args):
                    captured["taps"] = np.asarray(args[0])

            designer.connect_signal("tapsChanged", _Catch(), "setTaps")
            # setters before activation don't validate (reference
            # FIRDesigner::recalculate gates on isActive, :389)
            designer.set_sample_rate(fs)
            designer.set_filter_type(ftype)
            designer.set_band_type(band)
            designer.set_frequency_lower(fl)
            designer.set_frequency_upper(fu)
            designer.set_bandwidth_trans(fs / 20)
            designer.set_num_taps(101)
            designer._active = True
            designer.recalculate()
            taps = captured["taps"]
            bins = _power_bins(taps)
            for is_pass, f in _band_points(band, fs, fl, fu):
                level = bins[_bin_at(1024, fs, f)]
                if is_pass:
                    assert level > -30.0, f"{ftype}/{band} PASS@{f}: {level}"
                else:
                    assert level < -80.0, f"{ftype}/{band} STOP@{f}: {level}"


def test_fir_designer_validation():
    d = BlockRegistry.make("/comms/fir_designer")
    d._active = True
    with pytest.raises(ValueError):
        d.set_sample_rate(-1.0)
    d._samp_rate = 1.0
    with pytest.raises(ValueError):
        d.set_frequency_lower(-0.1)  # real band: must be positive
    d._freq_lower = 0.1
    d._band_type = "BAND_PASS"
    with pytest.raises(ValueError):
        d.set_num_taps(50)  # band filters need odd taps
    d._num_taps = 51
    with pytest.raises(ValueError):
        d.set_frequency_upper(0.05)  # upper <= lower


def test_fir_designer_backcompat_band_as_filter_type():
    d = BlockRegistry.make("/comms/fir_designer")
    d._active = True
    d.set_frequency_lower(0.1)
    d.set_filter_type("HIGH_PASS")  # legacy: band passed as filter type
    assert d.filter_type() == "SINC"
    assert d.band_type() == "HIGH_PASS"


# ---------------------------------------------------------------------- #
# IIR filter + designer (reference: filter/TestIIRFilter.cpp)
# ---------------------------------------------------------------------- #
def iir_oracle(x, taps):
    half = len(taps) // 2
    b, a = np.asarray(taps[:half], float), np.asarray(taps[half:], float)
    b, a = b / a[0], a / a[0]
    y = np.zeros(len(x), complex)
    for n in range(len(x)):
        acc = 0j
        for i in range(len(b)):
            if n - i >= 0:
                acc += b[i] * complex(x[n - i])
        for i in range(1, len(a)):
            if n - i >= 0:
                acc -= a[i] * y[n - i]
        y[n] = acc
    return y


def test_iir_default_taps_oracle():
    rng = np.random.default_rng(13)
    x = rng.normal(size=300).astype(np.float64)
    feed = FeederSource("float64")
    feed.feed_buffer(x)
    iir = BlockRegistry.make("/comms/iir_filter", "float64")
    sink = CollectorSink("float64")
    topo = Topology()
    topo.connect(feed, 0, iir, 0)
    topo.connect(iir, 0, sink, 0)
    topo.commit()
    assert topo.wait_inactive()
    exp = iir_oracle(x, [0.0676, 0.135, 0.0676, 1, -1.142, 0.412]).real
    assert_buffers_close(exp, sink.get_buffer(), 1e-9)


def test_iir_state_carry_across_chunks():
    rng = np.random.default_rng(14)
    x = rng.normal(size=200)
    taps = [0.2, 0.3, 1.0, -0.5]
    feed = FeederSource("float64")
    feed.feed_buffer(x[:77])
    feed.feed_buffer(x[77:])
    iir = BlockRegistry.make("/comms/iir_filter", "float64")
    iir.set_taps(taps)
    sink = CollectorSink("float64")
    topo = Topology()
    topo.connect(feed, 0, iir, 0)
    topo.connect(iir, 0, sink, 0)
    topo.commit()
    assert topo.wait_inactive()
    exp = iir_oracle(x, taps).real
    assert_buffers_close(exp, sink.get_buffer(), 1e-9)


def test_iir_complex_stream():
    rng = np.random.default_rng(15)
    x = (rng.normal(size=100) + 1j * rng.normal(size=100)).astype(np.complex128)
    taps = [0.5, 0.5, 1.0, -0.2]
    feed = FeederSource("complex_float64")
    feed.feed_buffer(x)
    iir = BlockRegistry.make("/comms/iir_filter", "complex_float64")
    iir.set_taps(taps)
    sink = CollectorSink("complex_float64")
    topo = Topology()
    topo.connect(feed, 0, iir, 0)
    topo.connect(iir, 0, sink, 0)
    topo.commit()
    assert topo.wait_inactive()
    exp = iir_oracle(x, taps)
    assert_buffers_close(exp, sink.get_buffer(), 1e-9)


def _freq_gain(b, a, f):
    z = np.exp(-2j * np.pi * f)
    num = np.polyval(b[::-1], z) / np.polyval(a[::-1], z)
    return abs(num)


@pytest.mark.parametrize("iir_type", ["butterworth", "chebyshev",
                                      "chebyshev2", "elliptic"])
def test_iir_designer_lowpass_properties(iir_type):
    captured = {}

    class _Catch:
        name = "c"

        def call(self, name, *args):
            captured["taps"] = np.asarray(args[0])

    d = BlockRegistry.make("/comms/iir_designer")
    d.connect_signal("tapsChanged", _Catch(), "setTaps")
    d._active = True
    d.set_iir_type(iir_type)
    d.set_filter_type("LOW_PASS")
    d.set_sample_rate(1.0)
    d.set_order(5)
    d.set_frequency_lower(0.1)
    taps = captured["taps"]
    half = len(taps) // 2
    b, a = taps[:half], taps[half:]
    # DC gain ~ 1 (within passband ripple), deep stopband at 0.4
    dc = _freq_gain(b, a, 1e-6)
    assert 10 ** (-0.2 / 20) < dc < 1.01
    assert _freq_gain(b, a, 0.4) < 10 ** (-40 / 20)
    # stable: poles inside unit circle
    assert np.max(np.abs(np.roots(a))) < 1.0


def test_iir_designer_bandpass():
    captured = {}

    class _Catch:
        name = "c"

        def call(self, name, *args):
            captured["taps"] = np.asarray(args[0])

    d = BlockRegistry.make("/comms/iir_designer")
    d.connect_signal("tapsChanged", _Catch(), "setTaps")
    d._active = True
    d.set_filter_type("BAND_PASS")
    d.set_sample_rate(1.0)
    d.set_order(3)
    d.set_frequency_lower(0.1)
    d.set_frequency_upper(0.2)
    taps = captured["taps"]
    half = len(taps) // 2
    b, a = taps[:half], taps[half:]
    assert _freq_gain(b, a, 0.15) > 0.7  # center
    assert _freq_gain(b, a, 0.02) < 0.1  # below band
    assert _freq_gain(b, a, 0.35) < 0.1  # above band
    assert np.max(np.abs(np.roots(a))) < 1.0


def test_iir_smoke_with_waveform():
    # reference filter/TestIIRFilter.cpp:16-51 style smoke: tone through
    # default lowpass keeps most of its power
    src = BlockRegistry.make("/comms/waveform_source", "float64")
    src.set_waveform("SINE")
    src.set_frequency(0.01)
    src.set_sample_rate(1.0)
    iir = BlockRegistry.make("/comms/iir_filter", "float64")
    probe = BlockRegistry.make("/comms/signal_probe", "float64")
    probe.set_mode("RMS")
    topo = Topology()
    topo.connect(src, 0, iir, 0)
    topo.connect(iir, 0, probe, 0)
    topo.run_source_elements(4096)
    assert probe.value() > 0.5  # sine RMS ~0.707 through DC-gain-1 lowpass


# ---------------------------------------------------------------------- #
# DC removal (reference: filter/DCRemoval.cpp + MovingAverage.hpp)
# ---------------------------------------------------------------------- #
def dc_removal_oracle(x, depth, cascade, is_int):
    hists = [[0] * depth for _ in range(cascade)]
    b1 = [0] * cascade
    out = []
    for v in x:
        y = v
        front0 = None
        for s in range(cascade):
            front = hists[s][0]
            a0 = y - front
            b0 = b1[s] + a0
            b1[s] = b0
            hists[s].pop(0)
            hists[s].append(y)
            if is_int:
                q = abs(b0) // depth
                y = q if (b0 >= 0) else -q
            else:
                y = b0 / depth
        front0 = hists[0][0]
        out.append(front0 - y)
    return out


def test_dc_removal_float_oracle():
    rng = np.random.default_rng(16)
    x = (rng.normal(size=400) + 3.0).astype(np.float64)
    feed = FeederSource("float64")
    feed.feed_buffer(x)
    blk = BlockRegistry.make("/comms/dc_removal", "float64")
    blk.set_average_size(32)
    blk.set_cascade_size(2)
    sink = CollectorSink("float64")
    topo = Topology()
    topo.connect(feed, 0, blk, 0)
    topo.connect(blk, 0, sink, 0)
    topo.commit()
    assert topo.wait_inactive()
    exp = np.array(dc_removal_oracle(x, 32, 2, False))
    assert_buffers_close(exp, sink.get_buffer(), 1e-9)
    # DC actually removed once settled
    assert abs(sink.get_buffer()[200:].mean()) < 0.1


def test_dc_removal_int16_exact():
    rng = np.random.default_rng(17)
    x = (rng.integers(-100, 100, 300) + 50).astype(np.int16)
    feed = FeederSource("int16")
    feed.feed_buffer(x)
    blk = BlockRegistry.make("/comms/dc_removal", "int16")
    blk.set_average_size(16)
    blk.set_cascade_size(2)
    sink = CollectorSink("int16")
    topo = Topology()
    topo.connect(feed, 0, blk, 0)
    topo.connect(blk, 0, sink, 0)
    topo.commit()
    assert topo.wait_inactive()
    exp = np.array(dc_removal_oracle([int(v) for v in x], 16, 2, True),
                   np.int16)
    assert_buffers_equal(exp, sink.get_buffer())


def test_dc_removal_chunked_state():
    rng = np.random.default_rng(18)
    x = (rng.normal(size=300) + 1.5).astype(np.float64)
    feed = FeederSource("float64")
    feed.feed_buffer(x[:111])
    feed.feed_buffer(x[111:])
    blk = BlockRegistry.make("/comms/dc_removal", "float64")
    blk.set_average_size(8)
    blk.set_cascade_size(3)
    sink = CollectorSink("float64")
    topo = Topology()
    topo.connect(feed, 0, blk, 0)
    topo.connect(blk, 0, sink, 0)
    topo.commit()
    assert topo.wait_inactive()
    exp = np.array(dc_removal_oracle(x, 8, 3, False))
    assert_buffers_close(exp, sink.get_buffer(), 1e-9)


# ---------------------------------------------------------------------- #
# Envelope detector (reference: filter/EnvelopeDetector.cpp)
# ---------------------------------------------------------------------- #
def envelope_oracle(xabs, attack, release):
    ga, gr = np.exp(-1.0 / attack), np.exp(-1.0 / release)
    env = 0.0
    out = []
    for v in xabs:
        g = ga if v > env else gr
        env = g * env + (1 - g) * v
        out.append(env)
    return np.array(out, np.float32)


def test_envelope_detector_complex():
    rng = np.random.default_rng(19)
    x = (rng.normal(size=500) + 1j * rng.normal(size=500)).astype(np.complex64)
    x[:250] *= 5.0
    feed = FeederSource("complex_float32")
    feed.feed_buffer(x)
    blk = BlockRegistry.make("/comms/envelope_detector", "complex_float32")
    blk.set_attack(8.0)
    blk.set_release(24.0)
    sink = CollectorSink("float32")
    topo = Topology()
    topo.connect(feed, 0, blk, 0)
    topo.connect(blk, 0, sink, 0)
    topo.commit()
    assert topo.wait_inactive()
    exp = envelope_oracle(np.abs(x).astype(np.float32), 8.0, 24.0)
    assert_buffers_close(exp, sink.get_buffer(), 1e-4)


def test_envelope_lookahead_delay():
    n = 200
    x = np.zeros(n, np.float32)
    x[100:] = 1.0
    look = 10
    feed = FeederSource("float32")
    feed.feed_buffer(x)
    blk = BlockRegistry.make("/comms/envelope_detector", "float32")
    blk.set_attack(2.0)
    blk.set_release(2.0)
    blk.set_lookahead(look)
    sink = CollectorSink("float32")
    topo = Topology()
    topo.connect(feed, 0, blk, 0)
    topo.connect(blk, 0, sink, 0)
    topo.commit()
    assert topo.wait_inactive()
    out = sink.get_buffer()
    # lookahead shifts the envelope to rise before the edge arrives in
    # the delayed stream; output is N - lookahead long
    assert out.shape[0] == n - look
    exp = envelope_oracle(x[look:], 2.0, 2.0)
    assert_buffers_close(exp, out, 1e-4)


# ---------------------------------------------------------------------- #
# Signal probe + window designer
# ---------------------------------------------------------------------- #
def test_signal_probe_modes():
    x = np.arange(1, 9, dtype=np.float64)
    for mode, exp in [("VALUE", 8.0), ("RMS", np.sqrt(np.mean(x ** 2))),
                      ("MEAN", x.mean())]:
        feed = FeederSource("float64")
        feed.feed_buffer(x)
        probe = BlockRegistry.make("/comms/signal_probe", "float64")
        probe.set_mode(mode)
        topo = Topology()
        topo.connect(feed, 0, probe, 0)
        topo.commit()
        assert topo.wait_inactive()
        assert abs(probe.value() - exp) < 1e-12, mode


def test_window_designer_known_values():
    captured = {}

    class _Catch:
        name = "c"

        def call(self, name, *args):
            captured["w"] = np.asarray(args[0])

    d = BlockRegistry.make("/comms/window_designer")
    d.connect_signal("tapsChanged", _Catch(), "setTaps")
    d._active = True
    d.set_num_taps(64)
    np.testing.assert_allclose(captured["w"], np.hanning(64), atol=1e-12)
    d.set_window_type("hamming")
    np.testing.assert_allclose(captured["w"], np.hamming(64), atol=1e-12)
    d.set_window_type("blackman")
    np.testing.assert_allclose(captured["w"], np.blackman(64), atol=1e-12)
    d.set_window_type("bartlett")
    np.testing.assert_allclose(captured["w"], np.bartlett(64), atol=1e-12)
    d.set_window_type("kaiser")
    d.set_window_args([8.6])
    np.testing.assert_allclose(captured["w"], np.kaiser(64, 8.6), atol=1e-12)
    d.set_window_type("chebyshev")
    d.set_window_args([100.0])
    w = captured["w"]
    assert w.max() == 1.0 and len(w) == 64
    # equiripple sidelobes at -100 dB beyond the mainlobe edge
    # (edge at acos(1/beta)/pi for Dolph-Chebyshev)
    beta = np.cosh(np.arccosh(10.0 ** (100 / 20.0)) / (64 - 1))
    edge = np.arccos(1.0 / beta) / np.pi
    W = np.abs(np.fft.fft(w, 16384))
    W /= W.max()
    sidelobe = 20 * np.log10(W[int(edge * 16384) + 50: 8192].max())
    assert -101.0 < sidelobe < -95.0


def test_window_designer_validation():
    d = BlockRegistry.make("/comms/window_designer")
    d._active = True
    with pytest.raises(ValueError):
        d.set_window_type("bogus")


def test_iir_blocked_core_matches_sequential():
    """The blocked state-space IIR core (associative scan, VERDICT r3
    next #4) must match the per-sample sequential scan exactly (f32
    tolerance), real and complex, across block-ladder quantum sizes."""
    import jax.numpy as jnp
    from pothoscomms_tpu.core.registry import BlockRegistry

    rng = np.random.default_rng(9)
    # a stable biquad (the block's default butterworth-ish taps)
    taps = [0.0676, 0.135, 0.0676, 1, -1.142, 0.412]
    for dtype, is_cplx in (("float32", False), ("complex_float32", True)):
        blk = BlockRegistry.make("/comms/iir_filter", dtype)
        blk.set_taps(taps)
        carry0, step = blk.device_core(1)
        for t in (1024, 4096, 96):  # 96: BLOCK_LS=32 path
            if is_cplx:
                x = jnp.asarray(
                    rng.normal(size=(1, t, 2)).astype(np.float32))
            else:
                x = jnp.asarray(rng.normal(size=(1, t)).astype(np.float32))
            z_blocked, y_blocked = step(carry0, x)
            # sequential oracle: force the fallback with t that no block
            # divides is hard to arrange for pow2 t; instead run the f64
            # streaming oracle via iir_df per plane
            from pothoscomms_tpu.ops.filter import iir_df

            b = np.asarray(taps[:3]) / taps[3]
            a = np.asarray(taps[3:]) / taps[3]
            xn = np.asarray(x)
            if is_cplx:
                xc = xn[0, :, 0] + 1j * xn[0, :, 1]
                y_ref, z_ref = iir_df(jnp.asarray(xc), jnp.asarray(b),
                                      jnp.asarray(a),
                                      jnp.zeros(2, jnp.complex128))
                y_ref = np.stack([np.asarray(y_ref).real,
                                  np.asarray(y_ref).imag], -1)[None]
            else:
                y_ref, z_ref = iir_df(jnp.asarray(xn[0]),
                                      jnp.asarray(b), jnp.asarray(a),
                                      jnp.zeros(2, jnp.float64))
                y_ref = np.asarray(y_ref)[None]
            np.testing.assert_allclose(np.asarray(y_blocked), y_ref,
                                       atol=2e-4, err_msg=f"{dtype} t={t}")
            # state continuity: second quantum picks up where the first
            # ended
            z2, y2 = step(z_blocked, x)
            if is_cplx:
                xc = xn[0, :, 0] + 1j * xn[0, :, 1]
                y2_ref, _ = iir_df(jnp.asarray(xc), jnp.asarray(b),
                                   jnp.asarray(a), z_ref)
                y2_ref = np.stack([np.asarray(y2_ref).real,
                                   np.asarray(y2_ref).imag], -1)[None]
            else:
                y2_ref, _ = iir_df(jnp.asarray(xn[0]),
                                   jnp.asarray(b), jnp.asarray(a),
                                   z_ref)
                y2_ref = np.asarray(y2_ref)[None]
            np.testing.assert_allclose(np.asarray(y2), y2_ref, atol=2e-4,
                                       err_msg=f"{dtype} t={t} q2")


def test_envelope_blocked_matches_sequential():
    """The warm-started blocked envelope follower (the one data-
    dependent recursion) must match the per-sample scan to f32
    resolution, including exact carry continuity across quanta."""
    import jax.numpy as jnp
    from pothoscomms_tpu.ops.filter import (
        envelope_blocked, envelope_scan, envelope_warmup)

    rng = np.random.default_rng(11)
    for attack, release in ((4.0, 16.0), (10.0, 40.0), (1.0, 1.0)):
        ga = np.float32(np.exp(-1.0 / attack))
        gr = np.float32(np.exp(-1.0 / release))
        W = envelope_warmup(attack, release)
        assert W <= 2048
        P, T, L = 3, 1 << 15, 4096
        x = np.abs(rng.normal(size=(P, T))).astype(np.float32)
        env0 = np.abs(rng.normal(size=P)).astype(np.float32)
        yb, eb = envelope_blocked(jnp.asarray(x), jnp.asarray(env0),
                                  ga, gr, L, W)
        for p in range(P):
            ys, es = envelope_scan(jnp.asarray(x[p]),
                                   jnp.float32(env0[p]), ga, gr)
            np.testing.assert_allclose(np.asarray(yb)[p], np.asarray(ys),
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(float(np.asarray(eb)[p]),
                                       float(es), rtol=1e-5)


def test_rational_fir_mm_matches_polyphase():
    """The blocked-Toeplitz matmul resampler must match the polyphase
    gather formulation exactly, incl. history continuity."""
    import jax.numpy as jnp
    from pothoscomms_tpu.ops.filter import (
        polyphase_fir, rational_fir_mm, rational_fir_operators)

    rng = np.random.default_rng(13)
    for M, L in ((2, 3), (3, 2), (1, 4), (4, 1)):
        K_TAPS = 60 - (60 % L)
        taps = ((rng.normal(size=K_TAPS) + 1j * rng.normal(size=K_TAPS))
                / K_TAPS)
        K = K_TAPS // L
        phases = np.zeros((L, K), np.complex128)
        for j in range(L):
            for k in range(K):
                phases[j, k] = taps[j + k * L]
        taps_q = jnp.asarray(
            np.stack([phases.real, phases.imag], -1).astype(np.float32))
        t0, t1, b_in, b_out = rational_fir_operators(taps, M, L)
        T = 4 * b_in
        hist = np.zeros((1, max(K - 1, 1), 2), np.float32)
        xs = [rng.normal(size=(1, T, 2)).astype(np.float32)
              for _ in range(2)]
        h = jnp.asarray(hist)
        for x in xs:
            y, h = rational_fir_mm(jnp.asarray(x), h, t0, t1, b_in, b_out)
            # oracle: gather polyphase over the same window with history
            xh = np.concatenate([hist[0], x[0]])
            y_ref = polyphase_fir(jnp.asarray(xh), taps_q, M, L, K,
                                  "planar", 0)
            hist = x[:, T - max(K - 1, 1):, :]
            np.testing.assert_allclose(
                np.asarray(y)[0], np.asarray(y_ref), atol=2e-4,
                err_msg=f"M={M} L={L}")


def test_iir_blocked_unstable_falls_back():
    """An unstable filter overflows the blocked operators' A^j powers —
    the device core must fall back to the sequential scan instead of
    baking inf/NaN constants."""
    import jax.numpy as jnp
    from pothoscomms_tpu.core.registry import BlockRegistry

    blk = BlockRegistry.make("/comms/iir_filter", "float32")
    blk.set_taps([1.0, 0.0, 1.0, -2.5])  # pole at 2.5: unstable
    carry0, step = blk.device_core(1)
    x = jnp.asarray(np.ones((1, 1024), np.float32) * 1e-3)
    z, y = step(carry0, x)
    # diverges (unstable) but must be FINITE for a while, not NaN from
    # overflowed operators
    assert np.all(np.isfinite(np.asarray(y)[0, :64]))
