"""Fused multichannel DSP chains.

A chain of blocks compiles into ONE jitted function over a
``[channels, time, 2]`` planar-complex block with explicit carry state —
the replacement for the reference's per-block scheduler hops
(SURVEY.md §2.13(1)). The FIR convolution runs as a single
``lax.conv_general_dilated`` with a 2x2 feature-mixing kernel (complex
multiply expressed as real conv) or as block-Toeplitz matmuls; the FFT
is the matmul factorization in parallel/fft.py. Which formulation wins
on the GPU is open (ROADMAP §1.4-1.5).
"""

from __future__ import annotations

from functools import partial
import numpy as np
import jax
import jax.numpy as jnp

from pothoscomms_tpu.parallel import cplx
from pothoscomms_tpu.parallel.fft import fft_planar


def complex_fir_kernel(taps: np.ndarray) -> jnp.ndarray:
    """Complex FIR taps -> [out=2, in=2, K] real conv kernel.

    (yr + j yi) = sum_k h[k] * x[n-k]:
      yr = hr*xr - hi*xi ; yi = hi*xr + hr*xi
    NB: conv kernels correlate in XLA IR terms; taps are time-reversed so
    the conv computes true convolution.
    """
    h = np.asarray(taps)
    hr = h.real.astype(np.float32)[::-1].copy()
    hi = h.imag.astype(np.float32)[::-1].copy() if np.iscomplexobj(h) \
        else np.zeros_like(hr)
    w = np.zeros((2, 2, len(h)), np.float32)
    w[0, 0], w[0, 1] = hr, -hi
    w[1, 0], w[1, 1] = hi, hr
    return jnp.asarray(w)


def make_fir_kernel(taps) -> jnp.ndarray:
    return complex_fir_kernel(np.asarray(taps))


@partial(jax.jit, static_argnames=("decim",))
def fir_multichannel(x, history, kernel, decim: int = 1):
    """Multichannel complex FIR over a time block.

    x: [C, T, 2] planar; history: [C, K-1, 2] carry from the previous
    block; kernel: [2, 2, K] from complex_fir_kernel.
    Returns (y [C, T//decim, 2], new_history).
    """
    k = kernel.shape[-1]
    xin = jnp.concatenate([history, x], axis=1)      # [C, K-1+T, 2]
    # NCW conv: batch=C, feature=(re,im), width=time
    lhs = jnp.moveaxis(xin, -1, 1)                    # [C, 2, K-1+T]
    out = jax.lax.conv_general_dilated(
        lhs, kernel,
        window_strides=(decim,),
        padding="VALID",
        dimension_numbers=("NCW", "OIW", "NCW"),
        preferred_element_type=jnp.float32,
        precision=cplx.PRECISION,
    )                                                  # [C, 2, T//decim]
    y = jnp.moveaxis(out, 1, -1)
    new_hist = xin[:, xin.shape[1] - (k - 1):, :] if k > 1 else \
        xin[:, :0, :]
    return y, new_hist


def fir_toeplitz_matrices(taps, block: int = 128):
    """Complex taps -> (T0, T1) block-Toeplitz matrices, each a planar
    [B, B, 2] pair, for the matmul FIR formulation.

    With time grouped into length-B blocks, causal convolution with K<=B
    taps is y_b = x_b @ T0 + x_{b-1} @ T1 where
    T0[i, j] = h[j - i] (0 <= j-i < K) and T1[i, j] = h[j - i + B].
    The zero band costs extra FLOPs, traded for matmul throughput.
    """
    h = np.asarray(taps, np.complex128)
    k = len(h)
    assert k <= block, "taps must fit one block"
    t0 = np.zeros((block, block), np.complex128)
    t1 = np.zeros((block, block), np.complex128)
    for d in range(k):
        t0 += np.diag(np.full(block - d, h[d]), k=d)
        if d > 0:
            t1 += np.diag(np.full(d, h[d]), k=d - block)
    t0j = np.stack([t0.real, t0.imag], -1).astype(np.float32)
    t1j = np.stack([t1.real, t1.imag], -1).astype(np.float32)
    return jnp.asarray(t0j), jnp.asarray(t1j)


@partial(jax.jit, static_argnames=("block",))
def fir_multichannel_mm(x, history, t0, t1, block: int = 128):
    """Matmul-form multichannel complex FIR (same output as
    fir_multichannel with decim=1; K-1 history carried in `history`).

    x: [C, T, 2] with T a multiple of `block`; history: [C, K-1, 2].
    """
    c, t, _ = x.shape
    k1 = history.shape[1]  # K-1
    nb = t // block
    xb = x.reshape(c, nb, block, 2)
    # previous block for each position: [hist-padded shift by one block]
    # only the last K-1 samples of the previous block matter; build the
    # "previous block" view with the stream history at block 0
    prev_tail = jnp.concatenate(
        [jnp.zeros((c, block - k1, 2), x.dtype), history], axis=1
    ) if k1 else jnp.zeros((c, block, 2), x.dtype)
    prev = jnp.concatenate([prev_tail[:, None], xb[:, :-1]], axis=1)

    def cmm(a, m):
        mm = lambda p, q: jnp.matmul(
            p, q, preferred_element_type=jnp.float32,
            precision=cplx.PRECISION,
        )
        ar, ai = a[..., 0], a[..., 1]
        mr, mi = m[..., 0], m[..., 1]
        return jnp.stack(
            [mm(ar, mr) - mm(ai, mi), mm(ar, mi) + mm(ai, mr)], axis=-1
        )

    y = cmm(xb, t0) + cmm(prev, t1)
    y = y.reshape(c, t, 2)
    new_hist = x[:, t - k1:, :] if k1 else x[:, :0, :]
    return y, new_hist


@partial(jax.jit, static_argnames=("nbins", "decim"))
def fir_fft_step(x, history, kernel, nbins: int, decim: int = 1):
    """One fused step of the north-star chain: FIR -> windowed FFT.

    x: [C, T, 2]; returns (spectra [C, T//decim//nbins, nbins, 2],
    new_history). T//decim must be a multiple of nbins.
    """
    y, hist = fir_multichannel(x, history, kernel, decim)
    c, t, _ = y.shape
    frames = y.reshape(c * (t // nbins), nbins, 2)
    spec = fft_planar(frames, nbins, False)
    return spec.reshape(c, t // nbins, nbins, 2), hist


@partial(jax.jit, static_argnames=("nbins",))
def fir_fft_step_mm(x, history, t0, t1, nbins: int):
    """Matmul-FIR variant of fir_fft_step (decim=1, K <= 128)."""
    y, hist = fir_multichannel_mm(x, history, t0, t1)
    c, t, _ = y.shape
    frames = y.reshape(c * (t // nbins), nbins, 2)
    spec = fft_planar(frames, nbins, False)
    return spec.reshape(c, t // nbins, nbins, 2), hist


# ---------------------------------------------------------------------- #
# Combined FIR*DFT operator: the whole FIR -> windowed-FFT chain is TWO
# complex matmuls per 1024-window,
#
#     spec_w = x_w @ G0 + prev_tail_w @ G1,   G = Toeplitz(h) . F
#
# each evaluated as THREE real matmuls (Karatsuba: yi from
# (ar+ai)(br+bi) - arbr - aibi). Folding everything into one dense
# operator trades ~3x the FLOPs for a single matmul pair with no
# intermediate passes; it was chosen on an accelerator whose memory
# bandwidth bound the separate form, and is open on the GPU (ROADMAP
# §1.5). G matrices are passed as ARGUMENTS, not closure constants,
# so they upload once and stay out of the compiled program.
# ---------------------------------------------------------------------- #
def combined_fir_fft_operators(taps, nbins: int, prev_pad: int = 128):
    """(G0 [nbins, nbins], G1 [prev_pad, nbins]) real/imag planes for the
    combined operator; prev_pad >= len(taps)-1."""
    h = np.asarray(taps, np.complex128)
    k = len(h)
    assert k - 1 <= prev_pad
    t0 = np.zeros((nbins, nbins), np.complex128)
    t1 = np.zeros((prev_pad, nbins), np.complex128)
    for d in range(k):
        for j in range(nbins):
            i = j - d
            if i >= 0:
                t0[i, j] = h[d]
            else:
                t1[prev_pad + i, j] = h[d]
    f = np.exp(-2j * np.pi * np.outer(np.arange(nbins),
                                      np.arange(nbins)) / nbins)
    g0 = t0 @ f
    g1 = t1 @ f
    pl = lambda z: (jnp.asarray(z.real.astype(np.float32)),
                    jnp.asarray(z.imag.astype(np.float32)))
    return pl(g0), pl(g1)


@partial(jax.jit, static_argnames=("nbins", "k", "prev_pad"))
def fir_fft_combined_step(x, hist, g0r, g0i, g0s, g1r, g1i, g1s,
                          nbins: int, k: int, prev_pad: int):
    """One combined FIR+FFT step: x [C, T, 2] -> (spectra
    [C, T//nbins, nbins, 2], new_hist [C, k-1, 2]).

    MERGED single-matmul form: the window and its previous tail
    concatenate into one [.., prev_pad + nbins] operand against the
    stacked [G1; G0] operator — one Karatsuba matmul triple instead of
    two."""
    c, t, _ = x.shape
    nw = t // nbins
    xw = x.reshape(c, nw, nbins, 2)
    first = jnp.concatenate(
        [jnp.zeros((c, 1, prev_pad - (k - 1), 2), x.dtype),
         hist[:, None]], axis=2)
    prev = jnp.concatenate(
        [first, xw[:, :-1, nbins - prev_pad:, :]], axis=1)
    a = jnp.concatenate([prev, xw], axis=2)  # [c, nw, pp + nbins, 2]
    g01r = jnp.concatenate([g1r, g0r], axis=0)
    g01i = jnp.concatenate([g1i, g0i], axis=0)
    g01s = jnp.concatenate([g1s, g0s], axis=0)
    mm = lambda p, w: jnp.matmul(p, w, preferred_element_type=jnp.float32,
                                 precision=cplx.PRECISION)
    ar, ai = a[..., 0], a[..., 1]
    p1 = mm(ar, g01r)
    p2 = mm(ai, g01i)
    p3 = mm(ar + ai, g01s)
    spec = jnp.stack([p1 - p2, p3 - p1 - p2], axis=-1)
    new_hist = x[:, t - (k - 1):, :] if k > 1 else x[:, :0, :]
    return spec, new_hist


# ---------------------------------------------------------------------- #
# Split-stream (radix-R) combined operator — the round-4 formulation.
#
# One level of radix-R decimation-in-frequency applied to the FIR
# OUTPUT, with the stream combines hoisted to the FIR INPUT: because
# the DIF stream weights W_R^{mr} are scalar constants (not diagonals),
# they commute with convolution, so
#
#     spec[R k' + r] = DFT_W( W_N^{j r} . conv(h, v_r)[j] )[k'],
#     v_r[j] = sum_m W_R^{m r} x[m W + j],        W = nbins / R,
#
# and each stream runs the SAME combined Toeplitz*DFT operator shape as
# the dense formulation, at width W with a pp >= K-1 "previous tail"
# pad. Matmul work drops from (nbins + 128) to (W + pp) complex MACs
# per sample (6x fewer at R=8, nbins=1024, pp=64) while everything
# stays one XLA program; the elementwise stream/history builds fuse
# into the matmul operand reads. The carry stays the SAME K-1 raw
# samples as the dense operator: stream histories decompose as
#     hist_r[w] = q_tail[w-1, R-1] + sum_{m>=1} W_R^{m r} q_tail[w, m-1]
# where q_tail[w, m] is the last K-1 samples of quarter m of window w —
# the m=0 term always has weight 1, so only raw samples cross the
# quantum boundary.
#
# The formulation is numerically clean but lost to the dense operator
# on the accelerator it was written for, where XLA materialized every
# v_r stream build as a full memory pass. Kept as the minimal-FLOP
# reference formulation (oracle-tested); production dispatch stays on
# the dense combined operator until ROADMAP §1.5 measures it on the
# GPU.
# ---------------------------------------------------------------------- #
def split_stream_fir_fft_operators(taps, nbins: int, R: int, pp: int):
    """Per-stream (G0 [W, W], G1 [pp, W]) planar operator pairs,
    G_r = Toeplitz(h) . diag(W_N^{r j}) . F_W, plus the W_R stream
    weight table. Returns (ops, wr) with ops a length-R list of
    ((g0r, g0i), (g1r, g1i)) and wr the [R, R] complex weights."""
    h = np.asarray(taps, np.complex128)
    k = len(h)
    W = nbins // R
    assert k - 1 <= pp <= W
    t0 = np.zeros((W, W), np.complex128)
    t1 = np.zeros((pp, W), np.complex128)
    for d in range(k):
        for j in range(W):
            i = j - d
            if i >= 0:
                t0[i, j] = h[d]
            else:
                t1[pp + i, j] = h[d]
    f = np.exp(-2j * np.pi * np.outer(np.arange(W), np.arange(W)) / W)
    pl = lambda z: (jnp.asarray(z.real.astype(np.float32)),
                    jnp.asarray(z.imag.astype(np.float32)))
    ops = []
    for r in range(R):
        tw = np.exp(-2j * np.pi * r * np.arange(W) / nbins)
        df = tw[:, None] * f
        ops.append((pl(t0 @ df), pl(t1 @ df)))
    wr = np.exp(-2j * np.pi * np.outer(np.arange(R), np.arange(R)) / R)
    return ops, wr


def make_split_step(taps, nbins: int, R: int, pp: int = 64):
    """Build the jitted split-stream step:
    (x [C, T, 2], hist [C, K-1, 2]) -> (spec [C, T//nbins, nbins, 2],
    new_hist). Same carry contract as fir_fft_combined_step."""
    taps = np.asarray(taps)
    k = len(taps)
    W = nbins // R
    ops, wr = split_stream_fir_fft_operators(taps, nbins, R, pp)
    # flat param tuple (jit args, not closure constants)
    flat = []
    for (g0r, g0i), (g1r, g1i) in ops:
        flat += [g0r, g0i, g0r + g0i, g1r, g1i, g1r + g1i]
    flat = tuple(flat)
    wr32 = wr.astype(np.complex64)

    @partial(jax.jit, static_argnames=())
    def step(x, hist, *gs):
        c, t, _ = x.shape
        nw = t // nbins
        k1 = k - 1
        xq = x.reshape(c, nw, R, W, 2)
        # last k1 samples of each quarter: [c, nw, R, k1, 2]
        qt = xq[:, :, :, W - k1:, :]
        # q_tail[w-1, R-1] with the stream carry at window 0
        prev_last = jnp.concatenate(
            [hist[:, None], qt[:, :-1, R - 1]], axis=1)  # [c, nw, k1, 2]
        mm = lambda a, w_: jnp.matmul(
            a, w_, preferred_element_type=jnp.float32,
            precision=cplx.PRECISION)

        def cmm3(a, wr_, wi_, ws_):
            ar, ai = a[..., 0], a[..., 1]
            p1 = mm(ar, wr_)
            p2 = mm(ai, wi_)
            p3 = mm(ar + ai, ws_)
            return p1 - p2, p3 - p1 - p2

        def wmul(z, wcplx):
            # planar multiply by a scalar complex constant
            arr, aii = z[..., 0], z[..., 1]
            cr, ci = np.float32(wcplx.real), np.float32(wcplx.imag)
            return jnp.stack([arr * cr - aii * ci,
                              arr * ci + aii * cr], axis=-1)

        zero_pad = jnp.zeros((c, nw, pp - k1, 2), x.dtype)
        specs = []
        for r in range(R):
            # v_r = sum_m W_R^{mr} x_m  (scalar combos fuse elementwise)
            v = wmul(xq[:, :, 0], wr32[r, 0])
            for m in range(1, R):
                v = v + wmul(xq[:, :, m], wr32[r, m])
            # hist_r = prev_last + sum_{m>=1} W_R^{mr} q_tail[w, m-1]
            hr = prev_last
            for m in range(1, R):
                hr = hr + wmul(qt[:, :, m - 1], wr32[r, m])
            hrp = jnp.concatenate([zero_pad, hr], axis=2)
            g = gs[6 * r: 6 * r + 6]
            yr0, yi0 = cmm3(v, g[0], g[1], g[2])
            yr1, yi1 = cmm3(hrp, g[3], g[4], g[5])
            specs.append(jnp.stack([yr0 + yr1, yi0 + yi1], axis=-1))
        # interleave: spec[R k' + r] = specs[r][k']
        spec = jnp.stack(specs, axis=3)          # [c, nw, W, R, 2]
        spec = spec.reshape(c, nw, nbins, 2)
        new_hist = x[:, t - k1:, :] if k1 else x[:, :0, :]
        return spec, new_hist

    def run(x, carry):
        return step(x, carry, *flat)

    hist0 = jnp.zeros((1, k - 1, 2), jnp.float32)  # caller sizes C
    return run, hist0


# ---------------------------------------------------------------------- #
# Circular-correction formulation: per 1024-window,
#
#     spec_w = FFT(x_w) . H  +  u_w @ Gc
#
# where H = FFT(h, nbins) (convolution theorem gives the CIRCULAR
# convolution's spectrum) and the small matmul corrects circular ->
# linear: only outputs j < K-1 differ, by
#     Delta[j] = sum_{m=1..K-1-j} h[j+m] * (prev[-m] - x_w[-m]),
# so with u_w[m-1] = prev_tail[-m] - x_w[-m] (K-1 values) and
# Gc[m-1, k] = sum_j h[j+m] F[j, k] precomputed, FFT(Delta) = u_w @ Gc.
# Cost per sample: ~(n1+n2) FFT MACs + 1 (H) + (K-1)/nbins matmul —
# ~4x fewer FLOPs than the dense combined operator. It lost to the
# dense operator on the accelerator it was written for (the two-factor
# FFT's transposes made it movement-bound). Kept as the minimal-FLOP
# reference formulation (exercised by tests); the production dispatch
# uses the combined operator, pending ROADMAP §1.5 on the GPU.
# ---------------------------------------------------------------------- #
def circ_correction_operators(taps, nbins: int):
    """(H [nbins] planar, Gc [K-1, nbins] planes) for the circular-
    correction chain."""
    h = np.asarray(taps, np.complex128)
    k = len(h)
    H = np.fft.fft(h, nbins)
    f = np.exp(-2j * np.pi * np.outer(np.arange(nbins),
                                      np.arange(nbins)) / nbins)
    gc = np.zeros((k - 1, nbins), np.complex128)
    for m in range(1, k):
        for j in range(0, k - m):
            gc[m - 1] += h[j + m] * f[j]
    pl = lambda z: (jnp.asarray(z.real.astype(np.float32)),
                    jnp.asarray(z.imag.astype(np.float32)))
    Hp = jnp.asarray(np.stack([H.real, H.imag], -1).astype(np.float32))
    return Hp, pl(gc)


@partial(jax.jit, static_argnames=("nbins", "k"))
def fir_fft_circ_step(x, hist, Hp, gcr, gci, gcs, nbins: int, k: int):
    """One circular-correction FIR+FFT step: x [C, T, 2] -> (spectra
    [C, T//nbins, nbins, 2], new_hist [C, k-1, 2])."""
    from pothoscomms_tpu.parallel import cplx
    from pothoscomms_tpu.parallel.fft import fft_planar

    c, t, _ = x.shape
    nw = t // nbins
    xw = x.reshape(c, nw, nbins, 2)
    spec = fft_planar(xw.reshape(c * nw, nbins, 2), nbins, False)
    spec = cplx.mul(spec.reshape(c, nw, nbins, 2), Hp[None, None])

    # u_w[m-1] = prev_tail[-m] - x_w[-m], m = 1..K-1: reversed tails
    tails = xw[:, :, nbins - (k - 1):, :][:, :, ::-1, :]  # [c, nw, K-1, 2]
    prev_tails = jnp.concatenate(
        [hist[:, None, ::-1, :], tails[:, :-1]], axis=1)
    u = prev_tails - tails
    mm = lambda a, w: jnp.matmul(a, w, preferred_element_type=jnp.float32,
                                 precision=cplx.PRECISION)
    ur, ui = u[..., 0], u[..., 1]
    p1 = mm(ur, gcr)
    p2 = mm(ui, gci)
    p3 = mm(ur + ui, gcs)
    delta = jnp.stack([p1 - p2, p3 - p1 - p2], axis=-1)
    spec = spec + delta
    new_hist = x[:, t - (k - 1):, :] if k > 1 else x[:, :0, :]
    return spec, new_hist


def fir_fft_chain(taps, nbins: int, channels: int, block: int,
                  decim: int = 1):
    """Build the jitted chain closure + initial carry for given shapes.

    decim == 1 with <= 129-tap filters and block % nbins == 0 uses the
    combined FIR*DFT operator. Falls back to the square-Toeplitz matmul
    FIR + matmul FFT, then the conv path for rational rates.
    """
    taps = np.asarray(taps)
    k = len(taps)
    hist0 = jnp.zeros((channels, k - 1, 2), jnp.float32)
    # prev_pad must not exceed nbins: the combined step slices the last
    # prev_pad samples of each previous window (xw[:, :-1, nbins-prev_pad:]),
    # so small-nbins chains get a correspondingly small pad when the taps
    # still fit; longer taps fall through to the Toeplitz/conv paths.
    prev_pad = min(128, nbins)
    if decim == 1 and 1 < k <= prev_pad + 1 and block % nbins == 0:
        (g0r, g0i), (g1r, g1i) = combined_fir_fft_operators(
            taps, nbins, prev_pad)
        g0s = g0r + g0i
        g1s = g1r + g1i

        def run(x, carry):
            return fir_fft_combined_step(
                x, carry, g0r, g0i, g0s, g1r, g1i, g1s, nbins, k, prev_pad)

        return run, hist0
    if decim == 1 and k <= 128 and block % 128 == 0:
        t0, t1 = fir_toeplitz_matrices(taps)

        def run(x, carry):
            return fir_fft_step_mm(x, carry, t0, t1, nbins)

        return run, hist0
    kernel = complex_fir_kernel(taps)

    def run(x, carry):
        return fir_fft_step(x, carry, kernel, nbins, decim)

    return run, hist0


# ---------------------------------------------------------------------- #
# FM receive chain (the 256-channel BASELINE.json config):
# freq_demod -> dc_removal(single stage approx per config) -> envelope
# ---------------------------------------------------------------------- #
@jax.jit
def freq_demod_planar(x, last):
    """FM discriminator on planar complex: out[i] = arg(x[i] * conj(x[i-1]))
    (reference: demod/FreqDemod.cpp:49-71). x: [C, T, 2]; last: [C, 1, 2].
    Returns (y [C, T] float32, new_last [C, 1, 2])."""
    prev = jnp.concatenate([last, x[:, :-1, :]], axis=1)
    prod = cplx.mul(x, cplx.conj(prev))
    y = jnp.arctan2(prod[..., 1], prod[..., 0])
    return y, x[:, -1:, :]
