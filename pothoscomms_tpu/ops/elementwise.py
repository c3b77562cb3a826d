"""Elementwise math op tables.

The behavioral contract of the reference's math module: the exact op list of
math/SIMD/MathBlocks.json over the full dtype matrix, with C++ scalar
semantics (integer wraparound, truncating integer division, C-style
float→int casts). These all lower to elementwise code and fuse
freely under XLA — the entire SIMD dispatch layer of the reference
(math/SIMD/*, runtime CPU-feature dispatch) collapses into this table.

Every function here takes/returns jnp arrays in *storage* representation:
complex-int dtypes are integer arrays with a trailing (re, im) axis
(see core/dtypes.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from pothoscomms_tpu.core.dtypes import DType
from pothoscomms_tpu.ops import cint
from pothoscomms_tpu.ops.fxpt import fxpt_atan2, q_rsqrt_f32


# --------------------------------------------------------------------- #
# C-semantics helpers
# --------------------------------------------------------------------- #
def c_idiv(a, b):
    """C++ integer division: truncation toward zero (lax.div semantics),
    guarded against division by zero (returns 0 — the reference's behavior
    is UB there; tests avoid it)."""
    b_safe = jnp.where(b == 0, jnp.ones_like(b), b)
    q = jax.lax.div(a, b_safe)
    return jnp.where(b == 0, jnp.zeros_like(q), q)


def c_cast(x, np_dtype):
    """C-style float→int conversion: truncate toward zero. For float targets
    a plain cast. (XLA convert_element_type truncates toward zero for
    float→int, matching C.)"""
    if np.dtype(np_dtype).kind in "fc":
        return x.astype(np_dtype)
    return jnp.trunc(x).astype(np_dtype) if np.dtype(x.dtype).kind in "fc" else x.astype(np_dtype)


# --------------------------------------------------------------------- #
# Binary arithmetic (reference: math/Arithmetic.cpp kernels + SIMD add/sub/
# mul/div) — N-ary chains are folds over these.
# --------------------------------------------------------------------- #
def binary_arith_fn(dtype: DType, op: str):
    dtype = DType.parse(dtype)
    op = op.upper()
    if dtype.is_complex_int:
        table = {"ADD": cint.add, "SUB": cint.sub, "MUL": cint.mul, "DIV": cint.div}
        return table[op]
    if op == "ADD":
        return lambda a, b: a + b
    if op == "SUB":
        return lambda a, b: a - b
    if op == "MUL":
        return lambda a, b: a * b
    if op == "DIV":
        if dtype.is_integer:
            return c_idiv
        return lambda a, b: a / b
    raise ValueError(f"unknown arithmetic op {op}")


# --------------------------------------------------------------------- #
# Const arithmetic (reference: math/ConstArithmetic.cpp, SIMD XPlusK etc.)
# --------------------------------------------------------------------- #
def const_arith_fn(dtype: DType, op: str):
    dtype = DType.parse(dtype)
    base = binary_arith_fn(dtype, {"X_PLUS_K": "ADD", "X_MINUS_K": "SUB",
                                   "K_MINUS_X": "SUB", "X_MULT_K": "MUL",
                                   "X_DIV_K": "DIV", "K_DIV_X": "DIV"}[op])
    if op in ("X_PLUS_K", "X_MINUS_K", "X_MULT_K", "X_DIV_K"):
        return lambda x, k: base(x, k)
    return lambda x, k: base(k, x)  # K_MINUS_X, K_DIV_X


CONST_ARITH_OPS = ["X_PLUS_K", "X_MINUS_K", "K_MINUS_X", "X_MULT_K", "X_DIV_K", "K_DIV_X"]


# --------------------------------------------------------------------- #
# Comparators → char 0/1 (reference: math/Comparator.cpp:151,
# math/ConstComparator.cpp:176)
# --------------------------------------------------------------------- #
_CMP = {
    ">": jnp.greater,
    "<": jnp.less,
    ">=": jnp.greater_equal,
    "<=": jnp.less_equal,
    "==": jnp.equal,
    "!=": jnp.not_equal,
}


def comparator_fn(op: str):
    cmp = _CMP[op]
    return lambda a, b: cmp(a, b).astype(jnp.int8)


COMPARATOR_OPS = list(_CMP)


# --------------------------------------------------------------------- #
# Unary float functions (reference: math/Trigonometric.cpp:176-385 +
# Log/Exp/Root/Gamma/ErrorFunction/Sigmoid/Sinc kernels)
# --------------------------------------------------------------------- #
def _sinc(x):
    # reference math/Sinc.cpp:36-37: |x| < 1e-6 -> 1 else sin(x)/x
    small = jnp.abs(x) < 1e-6
    safe = jnp.where(small, jnp.ones_like(x), x)
    return jnp.where(small, jnp.ones_like(x), jnp.sin(safe) / safe)


def _recip(f):
    return lambda x: 1.0 / f(x)


def _of_recip(f):
    return lambda x: f(1.0 / x)


TRIG_OPS = {
    "COS": jnp.cos,
    "SIN": jnp.sin,
    "TAN": jnp.tan,
    "SEC": _recip(jnp.cos),
    "CSC": _recip(jnp.sin),
    "COT": _recip(jnp.tan),
    "ACOS": jnp.arccos,
    "ASIN": jnp.arcsin,
    "ATAN": jnp.arctan,
    "ASEC": _of_recip(jnp.arccos),
    "ACSC": _of_recip(jnp.arcsin),
    "ACOT": _of_recip(jnp.arctan),
    "COSH": jnp.cosh,
    "SINH": jnp.sinh,
    "TANH": jnp.tanh,
    "SECH": _recip(jnp.cosh),
    "CSCH": _recip(jnp.sinh),
    "COTH": _recip(jnp.tanh),
    "ACOSH": jnp.arccosh,
    "ASINH": jnp.arcsinh,
    "ATANH": jnp.arctanh,
    "ASECH": _of_recip(jnp.arccosh),
    "ACSCH": _of_recip(jnp.arcsinh),
    "ACOTH": _of_recip(jnp.arctanh),
}

UNARY_FLOAT_OPS = {
    "log": jnp.log,
    "log2": jnp.log2,
    "log10": jnp.log10,
    "log1p": jnp.log1p,
    "exp": jnp.exp,
    "exp2": jnp.exp2,
    "exp10": lambda x: jnp.power(10.0, x),  # math/Exp10.hpp.in:6-7
    "expm1": jnp.expm1,
    "sqrt": jnp.sqrt,
    "cbrt": jnp.cbrt,
    "sigmoid": lambda x: 1.0 / (1.0 + jnp.exp(-x)),
    "sinc": _sinc,
    "gamma": lambda x: jnp.exp(jax.lax.lgamma(x)) * jnp.where(
        (x < 0) & (jnp.floor(x * 0.5) * 2 != jnp.floor(x)), -1.0, 1.0
    ),
    "lngamma": jax.lax.lgamma,
    "erf": jax.lax.erf,
    "erfc": jax.lax.erfc,
}


def tgamma(x):
    """std::tgamma: true gamma with sign (lgamma gives log|Γ|)."""
    # Γ(x) sign is negative on intervals (-2k-1, -2k); use reflection parity.
    sign = jnp.where((x < 0) & (jnp.mod(jnp.floor(x), 2) == 0), -1.0, 1.0)
    return sign * jnp.exp(jax.lax.lgamma(x))


UNARY_FLOAT_OPS["gamma"] = tgamma


def unary_fn(dtype: DType, name: str):
    """Unary op for a dtype with reference cast semantics: integer dtypes
    evaluate in float then C-cast back (e.g. math/Log.cpp:82 std::log on
    an int operand promotes to double, then Type() truncates)."""
    dtype = DType.parse(dtype)
    f = UNARY_FLOAT_OPS[name] if name in UNARY_FLOAT_OPS else TRIG_OPS[name]
    if dtype.is_float:
        return lambda x: f(x)
    npdt = dtype.scalar.np

    def wrapped(x):
        return c_cast(f(x.astype(jnp.float64)), npdt)

    return wrapped


def logn_fn(dtype: DType, base: float):
    dtype = DType.parse(dtype)

    def f(x):
        return jnp.log(x) / np.log(base)

    if dtype.is_float:
        return f
    npdt = dtype.scalar.np
    return lambda x: c_cast(f(x.astype(jnp.float64)), npdt)


def expn_fn(dtype: DType, base: float):
    dtype = DType.parse(dtype)

    def f(x):
        return jnp.power(jnp.asarray(base, x.dtype if np.dtype(x.dtype).kind == "f" else jnp.float64), x)

    if dtype.is_float:
        return lambda x: jnp.power(jnp.asarray(base, x.dtype), x)
    npdt = dtype.scalar.np
    return lambda x: c_cast(f(x), npdt)


def pow_fn(dtype: DType):
    """x^k with runtime exponent (reference math/Pow.cpp:35-42:
    Type(std::pow(in, exponent)) — evaluate in double, C-cast back)."""
    dtype = DType.parse(dtype)
    if dtype.is_float:
        return lambda x, k: jnp.power(x, k)
    npdt = dtype.scalar.np
    return lambda x, k: c_cast(jnp.power(x.astype(jnp.float64), k.astype(jnp.float64)), npdt)


def root_fn(dtype: DType, which: str):
    """sqrt/cbrt/nth_root (reference math/Root.cpp). nth root = x**(1/n)."""
    dtype = DType.parse(dtype)
    if which == "sqrt":
        f = jnp.sqrt
    elif which == "cbrt":
        f = jnp.cbrt
    else:
        f = None
    if which == "nth":
        if dtype.is_float:
            return lambda x, n: jnp.power(x, 1.0 / n)
        npdt = dtype.scalar.np
        return lambda x, n: c_cast(
            jnp.power(x.astype(jnp.float64), 1.0 / n.astype(jnp.float64)), npdt
        )
    if dtype.is_float:
        return lambda x: f(x)
    npdt = dtype.scalar.np
    return lambda x: c_cast(f(x.astype(jnp.float64)), npdt)


def rsqrt_fn(dtype: DType):
    """Reference math/RSqrt.hpp: float32 uses the fast-inverse-sqrt
    approximation; float64 uses 1/sqrt; ints evaluate the float32
    approximation on the promoted value then C-cast (the reference only
    registers float/double — see the rsqrt block factory)."""
    dtype = DType.parse(dtype)
    if dtype.name == "float32":
        return q_rsqrt_f32
    return lambda x: 1.0 / jnp.sqrt(x)


def beta_fn(dtype: DType):
    """B(x, y) = Γ(x)Γ(y)/Γ(x+y) (reference math/Beta.cpp — float only)."""

    def f(x, y):
        sign = (
            jnp.sign(tgamma_sign(x)) * jnp.sign(tgamma_sign(y)) * jnp.sign(tgamma_sign(x + y))
        )
        mag = jnp.exp(jax.lax.lgamma(x) + jax.lax.lgamma(y) - jax.lax.lgamma(x + y))
        return sign * mag

    return f


def tgamma_sign(x):
    return jnp.where((x < 0) & (jnp.mod(jnp.floor(x), 2) == 0), -1.0, 1.0)


def abs_fn(dtype: DType):
    """|x| (reference math/Abs.cpp: signed types; complex → magnitude;
    fixed-point complex via functions/FxptHelpers.hpp getAbs)."""
    dtype = DType.parse(dtype)
    if dtype.is_complex_int:
        npdt = dtype.scalar.np
        return lambda x: cint.abs_int(x, npdt)
    if dtype.is_complex:
        return lambda x: jnp.abs(x)
    return lambda x: jnp.abs(x)


def angle_fn(dtype: DType):
    """arg(x) (reference math/Angle.cpp; integer path via fxpt_atan2 —
    functions/FxptHelpers.hpp:14-29)."""
    dtype = DType.parse(dtype)
    if dtype.is_complex_int:
        npdt = dtype.scalar.np

        def f(x):
            r16 = x[..., 0].astype(jnp.int16)
            i16 = x[..., 1].astype(jnp.int16)
            return fxpt_atan2(i16, r16).astype(npdt)

        return f
    return lambda x: jnp.angle(x)


def conjugate_fn(dtype: DType):
    dtype = DType.parse(dtype)
    if dtype.is_complex_int:
        return cint.conj
    return jnp.conj


def modf_fn(dtype: DType):
    """Split into integral and fractional parts, both carrying the sign
    (std::modf semantics; reference math/ModF.cpp:17-40)."""

    def f(x):
        integral = jnp.trunc(x)
        return integral, x - integral

    return f
