"""Planar-complex float32 helpers.

The fused device kernels carry complex values as a trailing (re, im)
axis of size 2 of float32. These helpers keep that representation
readable. (Same layout as the complex-int streams in
core/dtypes.py, so host<->device conversion is uniform.)
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

# Precision of every planar f32 contraction on the device. HIGHEST is
# plain FP32 (an FP32 cuBLAS GEMM on an H100). HIGH compiles to TF32
# there (10-bit mantissa, rel err ~2.5e-4 per product) and misses the
# reference's 0.01-abs FFT contract (fft/TestFFT.cpp:55-56) on the
# 1024-bin FIR->FFT chain with inputs in [-1, 1].
PRECISION = jax.lax.Precision.HIGHEST


def to_planar(x: np.ndarray) -> np.ndarray:
    """numpy complex array -> [..., 2] float32 planar."""
    x = np.asarray(x)
    if np.iscomplexobj(x):
        return np.stack([x.real, x.imag], axis=-1).astype(np.float32)
    return np.stack([x, np.zeros_like(x)], axis=-1).astype(np.float32)


def from_planar(x) -> np.ndarray:
    """[..., 2] planar -> numpy complex64."""
    x = np.asarray(x)
    return x[..., 0] + 1j * x[..., 1]


def re(x):
    return x[..., 0]


def im(x):
    return x[..., 1]


def make(r, i):
    return jnp.stack([r, i], axis=-1)


def mul(a, b):
    """Elementwise complex multiply of planar arrays."""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return make(ar * br - ai * bi, ar * bi + ai * br)


def conj(x):
    return make(x[..., 0], -x[..., 1])


def abs2(x):
    return x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]


def cabs(x):
    return jnp.sqrt(abs2(x))


def matmul(x, f_re, f_im):
    """Planar-complex matrix multiply: x [..., N, 2] @ F [N, M] complex
    given as two real matrices, at ``PRECISION``. Four real matmuls.

    Returns [..., M, 2].
    """
    mm = lambda a, b: jnp.matmul(
        a, b, preferred_element_type=jnp.float32, precision=PRECISION
    )
    xr, xi = x[..., 0], x[..., 1]
    yr = mm(xr, f_re) - mm(xi, f_im)
    yi = mm(xr, f_im) + mm(xi, f_re)
    return make(yr, yi)
