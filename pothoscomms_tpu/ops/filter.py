"""Filter functional cores (jnp, jitted per shape).

Vectorized reformulations of the reference filter hot loops:

- ``polyphase_fir``: the rational-resampler convolution
  (filter/FIRFilter.cpp:286-302) as a vectorized gather + phase-selected
  dot over all outputs at once — the per-sample interp/decim counter loop
  becomes static index arithmetic (outputs sit at upsampled positions
  u = t*M + M-1; phase j = u mod L, input index n = u div L).
- ``iir_df``: spuce-style direct-form II transposed recursion with double
  accumulation (filter/IIRFilter.cpp:94-96) as a ``lax.scan``.
- ``moving_average_cascade`` / ``dc_removal``: the integrator+comb moving
  average (filter/MovingAverage.hpp:38-50, DCRemoval.cpp:100-110) as
  cumulative sums — exact including integer wraparound, since modular
  arithmetic telescopes identically.
- ``envelope_scan``: attack/release one-pole follower
  (filter/EnvelopeDetector.cpp:131-143) as a ``lax.scan``.

Fixed-point paths follow Pothos Q-format semantics exactly
(core/qformat.py): taps scaled by 2**(bits/2) with truncation; integer
products wrap; outputs arithmetic-shifted right by half the accumulator
width.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from pothoscomms_tpu.core.dtypes import DType
from pothoscomms_tpu.core.qformat import Q_ACCUMULATOR, float_to_q
from pothoscomms_tpu.parallel.cplx import PRECISION


# ---------------------------------------------------------------------- #
# Polyphase rational-resampling FIR
# ---------------------------------------------------------------------- #
def _polyphase_matrix(taps: np.ndarray, L: int) -> Tuple[np.ndarray, int]:
    """taps[i] -> phases[j, k] = taps[j + k*L], zero padded. K = ceil(n/L)."""
    n = len(taps)
    K = n // L + (0 if n % L == 0 else 1)
    out = np.zeros((L, K), dtype=taps.dtype)
    for j in range(L):
        for k in range(K):
            i = j + k * L
            if i < n:
                out[j, k] = taps[i]
    return out, K


def fir_tap_state(taps, L: int, data_dtype: DType, complex_taps: bool):
    """Precompute device-ready Q-format polyphase taps for a data dtype.

    Mirrors the factory's Q-type table (filter/FIRFilter.cpp:369-383):
    int8 -> int16 taps/acc, int16 -> int32, int32/64 -> int64,
    float -> same-width float.
    """
    taps = np.asarray(taps)
    phases, K = _polyphase_matrix(taps, L)
    if data_dtype.is_float:
        # floatToQ<float/double> is a plain cast; accumulate in data width
        tdt = np.complex128 if complex_taps else np.float64
        acc = (np.complex64 if complex_taps else np.float32) if \
            data_dtype.bits == 32 else (np.complex128 if complex_taps else np.float64)
        q = phases.astype(tdt)
        if data_dtype.bits == 32:
            q = q.astype(np.complex64 if complex_taps else np.float32)
        return q, K
    # fixed point: scale by 2**(qbits/2), truncate (core/qformat semantics)
    qname = Q_ACCUMULATOR[data_dtype.scalar.name]
    qdt = DType.parse(("complex_" + qname) if complex_taps else qname)
    q = float_to_q(phases, qdt)  # [L, K] int or [L, K, 2] int
    return q, K


@partial(jax.jit, static_argnames=("M", "L", "K", "kind", "half_shift"))
def polyphase_fir(xh, taps_q, M: int, L: int, K: int, kind: str,
                  half_shift: int):
    """Run the rational resampler over one window.

    xh: input INCLUDING K-1 leading history samples — shape [K-1+N] (real /
    complex float) or [K-1+N, 2] (complex int as trailing re/im).
    taps_q: polyphase matrix from ``fir_tap_state``.
    kind: 'float' | 'int' | 'cint_rtaps' | 'cint_ctaps'.
    half_shift: Q shift for fixed point (half the accumulator width), 0 for
    float.

    Returns y with (N//M)*L elements in the reference's output order
    (filter/FIRFilter.cpp:286-302: output t sits at upsampled position
    u = t*M + (M-1); y[t] = sum_k taps[u%L, k] * x[u//L - k]).
    """
    if kind.startswith("cint"):
        n_in = xh.shape[0] - (K - 1)
    else:
        n_in = xh.shape[0] - (K - 1)
    N = (n_in // M) * M
    T = (N // M) * L
    u = jnp.arange(T) * M + (M - 1)
    n_idx = u // L
    j_idx = u % L
    # gather frames: frame[t, k] = xh[n_idx[t] + (K-1) - k]
    k_idx = jnp.arange(K)
    gidx = n_idx[:, None] + (K - 1) - k_idx[None, :]  # [T, K]

    if kind == "float":
        frames = xh[gidx]                      # [T, K]
        tsel = taps_q[j_idx]                   # [T, K]
        return jnp.sum(frames * tsel, axis=-1)

    if kind == "int":
        # real int data (QType int), real int taps
        acc_dt = taps_q.dtype
        frames = xh[gidx].astype(acc_dt)
        tsel = taps_q[j_idx]
        acc = jnp.sum(frames * tsel, axis=-1)
        return (acc >> half_shift)

    if kind == "cint_rtaps":
        # complex int data [.., 2], real int taps
        acc_dt = taps_q.dtype
        frames = xh[gidx].astype(acc_dt)       # [T, K, 2]
        tsel = taps_q[j_idx][..., None]        # [T, K, 1]
        acc = jnp.sum(frames * tsel, axis=1)   # [T, 2]
        return (acc >> half_shift)

    if kind == "planar":
        # complex data/taps as planar f32 (the fused stream layout)
        fr = xh[gidx]                          # [T, K, 2]
        ts = taps_q[j_idx]                     # [T, K, 2]
        pr = fr[..., 0] * ts[..., 0] - fr[..., 1] * ts[..., 1]
        pi = fr[..., 0] * ts[..., 1] + fr[..., 1] * ts[..., 0]
        return jnp.stack([pr.sum(axis=1), pi.sum(axis=1)], axis=-1)

    if kind == "cint_ctaps":
        # complex int data, complex int taps: full complex MAC in Q type
        acc_dt = taps_q.dtype
        fr = xh[gidx].astype(acc_dt)           # [T, K, 2]
        ts = taps_q[j_idx]                     # [T, K, 2]
        pr = fr[..., 0] * ts[..., 0] - fr[..., 1] * ts[..., 1]
        pi = fr[..., 0] * ts[..., 1] + fr[..., 1] * ts[..., 0]
        acc = jnp.stack([pr.sum(axis=1), pi.sum(axis=1)], axis=-1)
        return (acc >> half_shift)

    raise ValueError(f"unknown fir kind {kind}")


def rational_fir_operators(taps, M: int, L: int, block_in: int = None):
    """Blocked-Toeplitz operators for the rational resampler as a
    matmul: over a block of B_in input samples producing
    B_out = B_in*L/M outputs,

        y_blk = x_blk @ T0 + prev_tail @ T1,

    with T0 [B_in, B_out], T1 [K-1, B_out] built from the polyphase
    map (filter/FIRFilter.cpp:286-302: output t at upsampled position
    u = t*M + M-1, y[t] = sum_k taps[u%L + k*L] * x[u//L - k]). The
    matmul replaces the [T, K] gather formulation — the same trade that
    won for the 1:1 FIR (fir_toeplitz_matrices).

    Returns (t0 planar [B_in, B_out, 2], t1 planar [K-1, B_out, 2],
    B_in, B_out)."""
    h = np.asarray(taps, np.complex128)
    # K = ceil(n/L) with zero padding, matching _polyphase_matrix
    K = len(h) // L + (0 if len(h) % L == 0 else 1)
    hp = np.zeros(K * L, np.complex128)
    hp[: len(h)] = h
    b_in = block_in or 128 * M
    assert b_in % M == 0
    b_out = (b_in // M) * L
    t0 = np.zeros((b_in, b_out), np.complex128)
    t1 = np.zeros((max(K - 1, 1), b_out), np.complex128)
    for t in range(b_out):
        u = t * M + (M - 1)
        n = u // L
        j = u % L
        for k in range(K):
            i = n - k
            c = hp[j + k * L]
            if i >= 0:
                t0[i, t] += c
            else:
                t1[(K - 1) + i, t] += c
    pl_ = lambda z: jnp.asarray(
        np.stack([z.real, z.imag], -1).astype(np.float32))
    return pl_(t0), pl_(t1), b_in, b_out


@partial(jax.jit, static_argnames=("b_in", "b_out"))
def rational_fir_mm(x, history, t0, t1, b_in: int, b_out: int):
    """Matmul rational resampler: x [C, T, 2] planar f32 with
    T % b_in == 0; history [C, K-1, 2] (K-1 previous INPUT samples).
    Returns (y [C, T*b_out//b_in, 2], new_history)."""
    c, t, _ = x.shape
    k1 = history.shape[1]
    nb = t // b_in
    xb = x.reshape(c, nb, b_in, 2)
    prev = jnp.concatenate(
        [history[:, None], xb[:, :-1, b_in - k1:, :]], axis=1)

    def cmm(a, m):
        mm = lambda p, q: jnp.matmul(
            p, q, preferred_element_type=jnp.float32, precision=PRECISION)
        ar, ai = a[..., 0], a[..., 1]
        mr, mi = m[..., 0], m[..., 1]
        return jnp.stack(
            [mm(ar, mr) - mm(ai, mi), mm(ar, mi) + mm(ai, mr)], axis=-1)

    y = cmm(xb, t0) + cmm(prev, t1)
    y = y.reshape(c, nb * b_out, 2)
    new_hist = x[:, t - k1:, :]
    return y, new_hist


# ---------------------------------------------------------------------- #
# IIR direct-form (spuce iir_df equivalent)
# ---------------------------------------------------------------------- #
@jax.jit
def iir_df(x, b, a, z0):
    """Direct-form II transposed IIR over a block.

    x: [N] (complex or real, any width — computed in double like spuce's
    ``iir_df<Type, double>``); b: [nb] float64; a: [na] float64 (a[0]=1);
    z0: [order] state (complex128 or float64).

    Returns (y_double, z_final); the caller narrows y to the stream dtype.
    """
    order = z0.shape[0]
    nb = b.shape[0]
    na = a.shape[0]
    bp = jnp.zeros(order + 1, b.dtype).at[:nb].set(b)
    ap = jnp.zeros(order + 1, a.dtype).at[:na].set(a)

    def step(z, xn):
        xn = xn.astype(z.dtype)
        yn = bp[0] * xn + z[0]
        znew = bp[1:] * xn - ap[1:] * yn + jnp.concatenate(
            [z[1:], jnp.zeros((1,), z.dtype)]
        )
        return znew, yn

    z_final, y = jax.lax.scan(step, z0, x)
    return y, z_final


def iir_blocked_operators(b: np.ndarray, a: np.ndarray, L: int):
    """Blocked state-space operators for the parallel IIR core
    (SURVEY.md hard-part #2: sequential recursions as blocked /
    associative-scan formulations).

    The DF-II-T recursion is linear: z_{n+1} = A z_n + g x_n,
    y_n = z_n[0] + b0 x_n, with
      A[i, 0] = -a[i+1], A[i, i+1] = 1;  g[i] = b[i+1] - a[i+1] b0.
    Over a block of L samples this is EXACT linear algebra (no
    approximation — only f32 rounding at use):
      y_block = Wz @ z_k + Hmat @ x_block         (per-block, parallel)
      z_{k+1} = M z_k + G @ x_block               (block recurrence)
    where h[0] = b0, h[d] = (A^{d-1} g)[0] (truncated impulse
    response), Hmat[j, m] = h[j-m] (lower-triangular Toeplitz),
    Wz[j] = (A^j)[0, :], M = A^L, G[:, j] = A^{L-1-j} g. The remaining
    block recurrence has CONSTANT M, so it runs as a parallel
    ``lax.associative_scan`` — nothing in the core is per-sample
    sequential. All operators computed here in float64.

    Returns (Hmat [L, L], Wz [L, O], M [O, O], G [O, L]) as float64.
    """
    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    order = max(len(b), len(a)) - 1
    order = max(order, 1)
    bp = np.zeros(order + 1)
    bp[: len(b)] = b
    ap = np.zeros(order + 1)
    ap[: len(a)] = a
    A = np.zeros((order, order))
    A[:, 0] = -ap[1:]
    if order > 1:
        A[: order - 1, 1:] += np.eye(order - 1)
    g = bp[1:] - ap[1:] * bp[0]
    pw = [np.eye(order)]
    for _ in range(L):
        pw.append(A @ pw[-1])
    h = np.zeros(L)
    h[0] = bp[0]
    for d in range(1, L):
        h[d] = (pw[d - 1] @ g)[0]
    Hmat = np.zeros((L, L))
    for j in range(L):
        Hmat[j, : j + 1] = h[: j + 1][::-1]
    Wz = np.stack([pw[j][0, :] for j in range(L)])
    M = pw[L]
    G = np.stack([pw[L - 1 - j] @ g for j in range(L)], axis=1)
    return Hmat, Wz, M, G


def iir_blocked_step(xp, z0, Hmat, Wz, M, G, L: int):
    """One blocked-IIR quantum: xp [P, T] planes (T % L == 0), z0
    [O, P] state -> (y [P, T], z_final [O, P]). Fully parallel: two
    matmuls + one associative scan over T/L blocks."""
    P, t = xp.shape
    order = z0.shape[0]
    nb = t // L
    xb = xp.reshape(P, nb, L)
    # PRECISION (plain f32) throughout: the recurrence compounds
    # per-block error, and a reduced-precision contraction (TF32 on a
    # GPU) would breach the f64-oracle tolerance
    es = partial(jnp.einsum, precision=PRECISION,
                 preferred_element_type=jnp.float32)
    u = es("pnl,ol->nop", xb, G)  # [nb, O, P]
    Mt = jnp.broadcast_to(M, (nb, order, order))

    def comb(ea, eb):
        Pa, va = ea
        Pb, vb = eb
        return (es("kij,kjl->kil", Pb, Pa),
                es("kij,kjp->kip", Pb, va) + vb)

    Cc, w = jax.lax.associative_scan(comb, (Mt, u), axis=0)
    z_next = es("kij,jp->kip", Cc, z0) + w  # z_{k+1}, k=0..nb-1
    zs = jnp.concatenate([z0[None], z_next[:-1]], axis=0)  # z_k per block
    y = (es("jo,kop->pkj", Wz, zs)
         + es("jm,pkm->pkj", Hmat, xb))
    return y.reshape(P, t), z_next[-1]


# ---------------------------------------------------------------------- #
# Moving average cascade / DC removal
# ---------------------------------------------------------------------- #
def _trunc_div(a, d: int, is_int: bool):
    if is_int:
        return jax.lax.div(a, jnp.asarray(d, a.dtype))
    return a / d


@partial(jax.jit, static_argnames=("depth", "is_int"))
def moving_average_stage(ext, depth: int, is_int: bool):
    """One moving-average stage over ``ext`` = [depth hist, N new samples]
    in the accumulator dtype. Returns the N window-average outputs
    (exact vs the reference's integrator+comb: the running integrator
    telescopes to a width-``depth`` rolling sum, identically mod 2^bits)."""
    csum = jnp.cumsum(ext, axis=0)
    n = ext.shape[0] - depth
    s = csum[depth:] - csum[:n]
    return _trunc_div(s, depth, is_int)


@partial(jax.jit, static_argnames=("depth", "cascade", "is_int"))
def dc_removal(x_acc, hists, depth: int, cascade: int, is_int: bool):
    """DC removal cascade (reference: filter/DCRemoval.cpp:100-110).

    x_acc: [N] new samples in accumulator dtype. hists: [cascade, depth]
    per-stage input history (oldest first). Returns (y, new_hists) where
    y[i] = delayed_input - dc_estimate: stage0 input delayed by depth-1
    minus the cascaded average (narrowing happens in the caller).
    """
    outs = []
    new_hists = []
    cur = x_acc
    for s in range(cascade):
        ext = jnp.concatenate([hists[s], cur])
        avg = moving_average_stage(ext, depth, is_int)
        new_hists.append(ext[-depth:])
        if s == 0:
            # filters[0].front() after update at step i = ext[i+1]
            delayed = jax.lax.dynamic_slice_in_dim(ext, 1, x_acc.shape[0])
        cur = avg
    y = delayed - cur
    return y, jnp.stack(new_hists)


# ---------------------------------------------------------------------- #
# Envelope follower
# ---------------------------------------------------------------------- #
@jax.jit
def envelope_scan(xabs, env0, attack_gain, release_gain):
    """Attack/release envelope (reference: EnvelopeDetector.cpp:131-143).
    xabs: [N] float magnitudes; env0: scalar initial envelope."""
    ga = attack_gain
    gr = release_gain

    def step(env, xn):
        g = jnp.where(xn > env, ga, gr)
        env = g * env + (1.0 - g) * xn
        return env, env

    env_f, y = jax.lax.scan(step, env0, xabs)
    return y, env_f


def envelope_warmup(attack: float, release: float) -> int:
    """Samples after which the follower's initial condition decays below
    f32 resolution: |d env_N / d env_0| <= max(ga, gr)^N < 2^-25 at
    N = 25 ln2 * tau_max. Rounded up to a multiple of 256."""
    tau = max(attack, release, 1.0)
    w = int(np.ceil(25.0 * np.log(2.0) * tau))
    return ((w + 255) // 256) * 256


def envelope_blocked(xabs, env0, attack_gain, release_gain,
                     L: int, W: int):
    """Blocked-parallel attack/release follower (SURVEY.md hard-part #2
    for the one data-DEPENDENT recursion in the catalog).

    The recurrence env' = g(x, env) env + (1-g) x is nonlinear (g picks
    attack/release by comparing x to env) so no associative scan exists
    — but it is CONTRACTIVE: both slopes are < 1, so the initial
    condition washes out below f32 resolution within W samples
    (envelope_warmup). Split time into L-blocks and run every block as
    an independent row of ONE batched scan over W+L steps, each row
    warm-started from the W samples before its block. Row 0's warmup is
    the CONSTANT env0 — a fixed point of the recurrence (x == env keeps
    env exactly), so the carried state stays exact across quanta. The
    scan runs W+L sequential steps on [P, nb] vectors instead of T
    scalar steps: ~T/(W+L) x fewer sequential steps.

    xabs: [P, T] (T % L == 0); env0: [P]. Returns (y [P, T], env [P]).
    """
    ga = attack_gain
    gr = release_gain
    P, T = xabs.shape
    nb = T // L
    # W rounded UP to a whole number of L-blocks: the overlapping
    # window tensor is then built from K+1 SHIFTED VIEWS of a plain
    # [P, nb+K, L] reshape — zero gathers (a fancy-index window build
    # materializes a per-element gather). A longer warmup only tightens
    # the 2^-25 convergence bound.
    K = -(-W // L)
    Wr = K * L
    # xfull[p, Wr + t] = x[p, t]; the first Wr entries are the env0
    # fixed point so block 0's warmup is exact
    xfull = jnp.concatenate(
        [jnp.broadcast_to(env0[:, None], (P, Wr)), xabs], axis=1)
    rows = xfull.reshape(P, nb + K, L)
    wins = jnp.stack([rows[:, k:k + nb] for k in range(K + 1)], axis=0)
    # [K+1, P, nb, L] -> [K+1, L, P, nb] -> [(K+1)*L = Wr+L, P, nb]
    xt = jnp.transpose(wins, (0, 3, 1, 2)).reshape((K + 1) * L, P, nb)
    e_init = xt[0]                          # converges; exact for row 0

    def step(env, xn):
        g = jnp.where(xn > env, ga, gr)
        env = g * env + (1.0 - g) * xn
        return env, env

    env_f, ys = jax.lax.scan(step, e_init, xt)
    y = jnp.transpose(ys[Wr:], (1, 2, 0))   # [L, P, nb] -> [P, nb, L]
    y = y.reshape(P, T)
    return y, env_f[:, -1]
