"""Matmul FFT: Cooley-Tukey four-step factorization as real matmuls.

The fused chains compute the FFT on planar float32 as a two-factor
Cooley-Tukey decomposition N = N1*N2 (the formulation was chosen for an
accelerator without FFT or complex HLOs; ROADMAP §1.4 weighs it against
``jnp.fft`` on the GPU):

    X[k2*N1 + k1] = sum_{n2} W_N^{n2 k1} W_{N2}^{n2 k2}
                    * (sum_{n1} x[n1*N2 + n2] W_{N1}^{n1 k1})

Step 1: batched [*, N2, N1] @ [N1, N1] DFT matmul.
Step 2: elementwise twiddle multiply (fuses with step 1 epilogue).
Step 3: batched [*, N1, N2] @ [N2, N2] DFT matmul.

Complex arithmetic is planar float32 (parallel/cplx.py): each complex
matmul is 4 real matmuls. Cost per transform is N*(N1+N2) complex
MACs vs N*log2(N) for scalar radix-2 — 3-5x more FLOPs, traded for
matmul throughput. Small N (<= 256) uses a single direct DFT matmul.

Scaling matches the reference contract (fft/TestFFT.cpp): forward = plain
DFT; inverse = unnormalized (gain N over a round trip).
"""

from __future__ import annotations

from functools import lru_cache, partial

import numpy as np
import jax
import jax.numpy as jnp

from pothoscomms_tpu.parallel import cplx


@lru_cache(maxsize=64)
def dft_matrices(n: int, inverse: bool):
    """Real/imag parts of the DFT matrix W[j,k] = exp(-+2pi i jk/n).

    Cached as NUMPY so jit traces embed them as constants (caching jnp
    arrays would capture tracers when first called under trace).
    """
    j, k = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    sign = 2.0 if inverse else -2.0
    w = np.exp(sign * 1j * np.pi * j * k / n)
    return (w.real.astype(np.float32), w.imag.astype(np.float32))


@lru_cache(maxsize=64)
def _twiddles(n1: int, n2: int, inverse: bool):
    """W_N^{k1*n2} as [N1, N2] numpy planar pair."""
    k1, n2i = np.meshgrid(np.arange(n1), np.arange(n2), indexing="ij")
    sign = 2.0 if inverse else -2.0
    w = np.exp(sign * 1j * np.pi * k1 * n2i / (n1 * n2))
    return (w.real.astype(np.float32), w.imag.astype(np.float32))


def _split_factor(n: int) -> int:
    """Pick N1 with N2 = n/N1 the second-stage contraction size.

    Prefers a 128-wide second stage (N2 = 128); falls back to a
    near-sqrt split for other factorizations. The choice predates the
    GPU and is not re-measured there (ROADMAP §1.4).
    """
    if n % 128 == 0 and n // 128 >= 4:
        return n // 128
    for cand in (128, 64, 32, 16, 8, 4, 2):
        if n % cand == 0 and n // cand >= cand // 4:
            if cand * cand <= n * 4:
                return cand
    return 1


@partial(jax.jit, static_argnames=("n", "inverse"))
def fft_planar(x, n: int, inverse: bool = False):
    """Batched FFT of planar-complex input.

    x: [batch, n, 2] float32. Returns [batch, n, 2] float32.
    Forward: standard DFT. Inverse: unnormalized inverse DFT (x N gain).
    """
    assert x.shape[-2] == n and x.shape[-1] == 2
    if n <= 256:
        fr, fi = dft_matrices(n, inverse)
        return cplx.matmul(x, fr, fi)
    n1 = _split_factor(n)
    n2 = n // n1
    b = x.shape[0]
    # n = n1*n2, sample index n1_idx*n2 + n2_idx
    xr = x.reshape(b, n1, n2, 2)
    # step 1: DFT over n1 -> A[k1, n2]: contract axis n1
    xt = jnp.swapaxes(xr, 1, 2)                    # [b, n2, n1, 2]
    f1r, f1i = dft_matrices(n1, inverse)
    a = cplx.matmul(xt, f1r, f1i)                  # [b, n2, k1, 2]
    a = jnp.swapaxes(a, 1, 2)                      # [b, k1, n2, 2]
    # step 2: twiddle
    tr, ti = _twiddles(n1, n2, inverse)
    tw = jnp.asarray(np.stack([tr, ti], axis=-1))  # [k1, n2, 2]
    a = cplx.mul(a, tw[None])
    # step 3: DFT over n2 -> X[k1, k2]
    f2r, f2i = dft_matrices(n2, inverse)
    y = cplx.matmul(a, f2r, f2i)                   # [b, k1, k2, 2]
    # output index k = k2*n1 + k1 -> transpose [k2, k1]
    y = jnp.swapaxes(y, 1, 2).reshape(b, n, 2)
    return y


def fft_complex64_host(x: np.ndarray, inverse: bool = False) -> np.ndarray:
    """Host-side reference path (numpy), same scaling contract."""
    if inverse:
        return np.fft.ifft(x, axis=-1) * x.shape[-1]
    return np.fft.fft(x, axis=-1)
