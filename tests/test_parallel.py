"""Device execution-layer tests: planar complex, matmul FFT, fused chains,
mesh sharding (on the virtual 8-device CPU mesh), and the driver entry
points."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pothoscomms_tpu.parallel import cplx
from pothoscomms_tpu.parallel.chain import (
    complex_fir_kernel,
    fir_fft_chain,
    fir_multichannel,
    freq_demod_planar,
)
from pothoscomms_tpu.parallel.fft import fft_planar


def test_cplx_roundtrip_and_mul():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(4, 16)) + 1j * rng.normal(size=(4, 16))
    b = rng.normal(size=(4, 16)) + 1j * rng.normal(size=(4, 16))
    pa, pb = cplx.to_planar(a), cplx.to_planar(b)
    got = cplx.from_planar(cplx.mul(jnp.asarray(pa), jnp.asarray(pb)))
    np.testing.assert_allclose(got, a * b, rtol=1e-5)


@pytest.mark.parametrize("n", [64, 256, 512, 1024, 2048])
def test_fft_planar_matches_numpy(n):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n)))
    xp = jnp.asarray(cplx.to_planar(x))
    got = cplx.from_planar(np.asarray(fft_planar(xp, n, False)))
    exp = np.fft.fft(x, axis=-1)
    scale = np.abs(exp).max()
    np.testing.assert_allclose(got / scale, exp / scale, atol=2e-5)


@pytest.mark.parametrize("n", [256, 1024])
def test_fft_planar_inverse_unnormalized(n):
    rng = np.random.default_rng(n + 1)
    x = (rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n)))
    xp = jnp.asarray(cplx.to_planar(x))
    rt = cplx.from_planar(np.asarray(fft_planar(fft_planar(xp, n, False),
                                                n, True)))
    np.testing.assert_allclose(rt / n, x, atol=1e-3)


def test_fir_multichannel_matches_oracle():
    rng = np.random.default_rng(2)
    C, T, K = 4, 300, 12
    x = rng.normal(size=(C, T)) + 1j * rng.normal(size=(C, T))
    taps = (rng.normal(size=K) + 1j * rng.normal(size=K))
    kern = complex_fir_kernel(taps)
    hist = jnp.zeros((C, K - 1, 2), jnp.float32)
    y, hist2 = fir_multichannel(jnp.asarray(cplx.to_planar(x)), hist, kern)
    got = cplx.from_planar(np.asarray(y))
    for ch in range(C):
        exp = np.convolve(x[ch], taps, mode="full")[:T]
        np.testing.assert_allclose(got[ch], exp, atol=1e-3)
    # history = last K-1 inputs
    np.testing.assert_allclose(
        cplx.from_planar(np.asarray(hist2)), x[:, -(K - 1):], atol=1e-5
    )


def test_fir_carry_across_blocks():
    rng = np.random.default_rng(3)
    C, T, K = 2, 256, 8
    x = rng.normal(size=(C, 2 * T)) + 1j * rng.normal(size=(C, 2 * T))
    taps = rng.normal(size=K)
    kern = complex_fir_kernel(taps)
    hist = jnp.zeros((C, K - 1, 2), jnp.float32)
    y1, hist = fir_multichannel(jnp.asarray(cplx.to_planar(x[:, :T])), hist, kern)
    y2, hist = fir_multichannel(jnp.asarray(cplx.to_planar(x[:, T:])), hist, kern)
    got = np.concatenate(
        [cplx.from_planar(np.asarray(y1)), cplx.from_planar(np.asarray(y2))],
        axis=1,
    )
    for ch in range(C):
        exp = np.convolve(x[ch], taps, mode="full")[: 2 * T]
        np.testing.assert_allclose(got[ch], exp, atol=1e-3)


def test_fir_decimation():
    rng = np.random.default_rng(4)
    C, T, K, M = 2, 240, 6, 3
    x = rng.normal(size=(C, T)) + 1j * rng.normal(size=(C, T))
    taps = rng.normal(size=K)
    kern = complex_fir_kernel(taps)
    hist = jnp.zeros((C, K - 1, 2), jnp.float32)
    y, _ = fir_multichannel(jnp.asarray(cplx.to_planar(x)), hist, kern, M)
    got = cplx.from_planar(np.asarray(y))
    for ch in range(C):
        exp = np.convolve(x[ch], taps, mode="full")[:T][::M]
        np.testing.assert_allclose(got[ch], exp, atol=1e-3)


def test_fused_chain_shapes_and_content():
    rng = np.random.default_rng(5)
    C, T, K, NB = 4, 1024, 16, 256
    taps = rng.normal(size=K) / K
    run, hist0 = fir_fft_chain(taps, NB, C, T)
    x = rng.normal(size=(C, T)) + 1j * rng.normal(size=(C, T))
    spec, hist = run(jnp.asarray(cplx.to_planar(x)), hist0)
    assert spec.shape == (C, T // NB, NB, 2)
    # cross-check one frame
    y0 = np.convolve(x[0], taps, mode="full")[:T]
    exp = np.fft.fft(y0[:NB])
    got = cplx.from_planar(np.asarray(spec[0, 0]))
    np.testing.assert_allclose(got, exp, atol=2e-3)


def test_fused_chain_small_nbins_combined_path():
    """nbins < 128 must still dispatch to the combined operator (adaptive
    prev_pad) and match the convolution oracle (ADVICE r2 #1)."""
    rng = np.random.default_rng(51)
    C, T, K, NB = 2, 512, 33, 64
    taps = (rng.normal(size=K) + 1j * rng.normal(size=K)) / K
    run, hist0 = fir_fft_chain(taps, NB, C, T)
    x = rng.normal(size=(C, T)) + 1j * rng.normal(size=(C, T))
    spec, hist = run(jnp.asarray(cplx.to_planar(x)), hist0)
    assert spec.shape == (C, T // NB, NB, 2)
    y0 = np.convolve(x[0], taps, mode="full")[:T]
    for w in range(T // NB):
        exp = np.fft.fft(y0[w * NB: (w + 1) * NB])
        got = cplx.from_planar(np.asarray(spec[0, w]))
        np.testing.assert_allclose(got, exp, atol=2e-3)


def test_fir_fft_circ_step_matches_combined():
    """Circular-correction formulation parity vs the production combined
    operator (kept-as-reference path must not rot — ADVICE r2 #3)."""
    from pothoscomms_tpu.parallel.chain import (
        circ_correction_operators, combined_fir_fft_operators,
        fir_fft_circ_step, fir_fft_combined_step,
    )

    rng = np.random.default_rng(52)
    C, T, K, NB = 2, 2048, 29, 512
    taps = (rng.normal(size=K) + 1j * rng.normal(size=K)) / K
    x = rng.normal(size=(C, T, 2)).astype(np.float32)
    hist = rng.normal(size=(C, K - 1, 2)).astype(np.float32)

    Hp, (gcr, gci) = circ_correction_operators(taps, NB)
    gcs = gcr + gci
    spec_c, hc = fir_fft_circ_step(
        jnp.asarray(x), jnp.asarray(hist), Hp, gcr, gci, gcs, NB, K)

    pp = min(128, NB)
    (g0r, g0i), (g1r, g1i) = combined_fir_fft_operators(taps, NB, pp)
    spec_d, hd = fir_fft_combined_step(
        jnp.asarray(x), jnp.asarray(hist), g0r, g0i, g0r + g0i,
        g1r, g1i, g1r + g1i, NB, K, pp)

    np.testing.assert_allclose(np.asarray(spec_c), np.asarray(spec_d),
                               atol=5e-2)
    np.testing.assert_allclose(np.asarray(hc), np.asarray(hd), atol=0)


def test_freq_demod_planar():
    rng = np.random.default_rng(6)
    C, T = 2, 128
    phase = np.cumsum(rng.normal(size=(C, T)) * 0.3, axis=1)
    x = np.exp(1j * phase)
    last = jnp.asarray(cplx.to_planar(x[:, :1] * 0 + 1.0))  # start at 1+0j
    y, last2 = freq_demod_planar(jnp.asarray(cplx.to_planar(x)), last)
    got = np.asarray(y)
    prev = np.concatenate([np.ones((C, 1)), x[:, :-1]], axis=1)
    exp = np.angle(x * np.conj(prev))
    np.testing.assert_allclose(got, exp, atol=1e-5)


# ---------------------------------------------------------------------- #
# Mesh sharding on the virtual CPU mesh
# ---------------------------------------------------------------------- #
def test_channel_sharded_chain():
    from pothoscomms_tpu.parallel.mesh import make_mesh, channel_sharded_fir_fft

    n = min(8, len(jax.devices()))
    mesh = make_mesh(n, "ch")
    rng = np.random.default_rng(7)
    C, T, NB, K = 2 * n, 512, 128, 9
    taps = rng.normal(size=K) / K
    run, init_hist = channel_sharded_fir_fft(mesh, taps, NB)
    x = rng.normal(size=(C, T)) + 1j * rng.normal(size=(C, T))
    with mesh:
        spec, hist = run(jnp.asarray(cplx.to_planar(x)), init_hist(C))
    assert spec.shape == (C, T // NB, NB, 2)
    y0 = np.convolve(x[0], taps, mode="full")[:T]
    exp = np.fft.fft(y0[:NB])
    np.testing.assert_allclose(
        cplx.from_planar(np.asarray(spec[0, 0])), exp, atol=2e-3
    )


def test_time_sharded_fir_halo_exchange():
    from pothoscomms_tpu.parallel.mesh import make_mesh, time_sharded_fir
    from pothoscomms_tpu.parallel.chain import fir_multichannel

    n = min(8, len(jax.devices()))
    mesh = make_mesh(n, "t")
    rng = np.random.default_rng(8)
    C, K = 3, 7
    T = 64 * n
    taps = rng.normal(size=K) + 1j * rng.normal(size=K)
    run = time_sharded_fir(mesh, taps)
    x = rng.normal(size=(C, T)) + 1j * rng.normal(size=(C, T))
    carry = jnp.zeros((C, K - 1, 2), jnp.float32)
    with mesh:
        y, carry2 = run(jnp.asarray(cplx.to_planar(x)), carry)
    kern = complex_fir_kernel(taps)
    y_ref, hist_ref = fir_multichannel(
        jnp.asarray(cplx.to_planar(x)), carry, kern, 1
    )
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref), atol=1e-4)
    # carry comes back as the global stream tail
    np.testing.assert_allclose(
        cplx.from_planar(np.asarray(carry2)), x[:, -(K - 1):], atol=1e-5
    )


@pytest.mark.parametrize("decim", [2, 4])
def test_time_sharded_fir_decimated_halos(decim):
    """Decimation across shard boundaries (SURVEY hard part #5): the
    K-1 halo plus stride alignment must hold when each device's local
    slice length is a multiple of the decimation."""
    from pothoscomms_tpu.parallel.mesh import make_mesh, time_sharded_fir
    from pothoscomms_tpu.parallel.chain import fir_multichannel

    n = min(8, len(jax.devices()))
    mesh = make_mesh(n, "t")
    rng = np.random.default_rng(80 + decim)
    C, K = 2, 9
    T = 64 * n
    taps = rng.normal(size=K) + 1j * rng.normal(size=K)
    run = time_sharded_fir(mesh, taps, decim)
    x = rng.normal(size=(C, T)) + 1j * rng.normal(size=(C, T))
    carry = jnp.zeros((C, K - 1, 2), jnp.float32)
    with mesh:
        y, _ = run(jnp.asarray(cplx.to_planar(x)), carry)
    kern = complex_fir_kernel(taps)
    y_ref, _ = fir_multichannel(
        jnp.asarray(cplx.to_planar(x)), carry, kern, decim
    )
    assert y.shape == y_ref.shape == (C, T // decim, 2)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref), atol=1e-4)


@pytest.mark.parametrize("ml", [(2, 3), (3, 2), (1, 4)])
def test_time_sharded_resampler_halos(ml):
    """Rational L/M resampling across time shards (BASELINE config #3
    sharded): K-1 input halos + polyphase phase alignment."""
    from pothoscomms_tpu.parallel.mesh import (make_mesh,
                                               time_sharded_resampler)
    from pothoscomms_tpu.ops.filter import _polyphase_matrix, polyphase_fir

    M, L = ml
    n = min(8, len(jax.devices()))
    mesh = make_mesh(n, "t")
    rng = np.random.default_rng(90 + M * 10 + L)
    C, KT = 2, 12
    T = 24 * n
    taps = (rng.normal(size=KT) + 1j * rng.normal(size=KT)) / KT
    run = time_sharded_resampler(mesh, taps, M, L)
    x = rng.normal(size=(C, T)) + 1j * rng.normal(size=(C, T))
    xp = jnp.asarray(cplx.to_planar(x))
    phases, K = _polyphase_matrix(taps, L)
    carry = jnp.zeros((C, K - 1, 2), jnp.float32)
    with mesh:
        y, tail = run(xp, carry)

    # single-device reference: same polyphase kernel over the full stream
    tq = jnp.asarray(np.stack([phases.real, phases.imag], -1).astype(
        np.float32))
    xh = jnp.concatenate([carry, xp], axis=1)
    y_ref = jax.vmap(lambda s: polyphase_fir(s, tq, M, L, K, "planar", 0))(xh)
    assert y.shape == y_ref.shape == (C, T * L // M, 2)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref), atol=1e-4)
    np.testing.assert_allclose(
        cplx.from_planar(np.asarray(tail)), x[:, -(K - 1):], atol=1e-5)


def test_graft_entry_compiles():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    spec, hist = out
    assert spec.shape[0] == args[0].shape[0]


def test_dryrun_multichip():
    import __graft_entry__ as ge

    n = min(8, len(jax.devices()))
    ge.dryrun_multichip(n)


def test_fir_matmul_form_matches_conv():
    from pothoscomms_tpu.parallel.chain import (
        fir_toeplitz_matrices, fir_multichannel_mm,
    )

    rng = np.random.default_rng(9)
    C, T, K = 3, 512, 64
    x = rng.normal(size=(C, T)) + 1j * rng.normal(size=(C, T))
    taps = rng.normal(size=K) + 1j * rng.normal(size=K)
    kern = complex_fir_kernel(taps)
    t0, t1 = fir_toeplitz_matrices(taps)
    hist = jnp.asarray(cplx.to_planar(rng.normal(size=(C, K - 1))
                                      + 1j * rng.normal(size=(C, K - 1))))
    y_conv, h_conv = fir_multichannel(jnp.asarray(cplx.to_planar(x)), hist, kern)
    y_mm, h_mm = fir_multichannel_mm(jnp.asarray(cplx.to_planar(x)), hist, t0, t1)
    np.testing.assert_allclose(np.asarray(y_mm), np.asarray(y_conv),
                               atol=2e-3)
    np.testing.assert_allclose(np.asarray(h_mm), np.asarray(h_conv), atol=1e-6)


def test_fir_matmul_carry_across_blocks():
    from pothoscomms_tpu.parallel.chain import (
        fir_toeplitz_matrices, fir_multichannel_mm,
    )

    rng = np.random.default_rng(10)
    C, T, K = 2, 256, 33
    x = rng.normal(size=(C, 2 * T)) + 1j * rng.normal(size=(C, 2 * T))
    taps = rng.normal(size=K)
    t0, t1 = fir_toeplitz_matrices(taps)
    hist = jnp.zeros((C, K - 1, 2), jnp.float32)
    y1, hist = fir_multichannel_mm(jnp.asarray(cplx.to_planar(x[:, :T])), hist, t0, t1)
    y2, hist = fir_multichannel_mm(jnp.asarray(cplx.to_planar(x[:, T:])), hist, t0, t1)
    got = np.concatenate([cplx.from_planar(np.asarray(y1)),
                          cplx.from_planar(np.asarray(y2))], axis=1)
    for ch in range(C):
        exp = np.convolve(x[ch], taps, mode="full")[: 2 * T]
        np.testing.assert_allclose(got[ch], exp, atol=1e-3)
