"""Shared test helpers.

the equivalent of the reference's ``common/Testing.hpp``:
``stdVectorToBufferChunk`` (trivial here — numpy), ``stretchStdVector``
(replicate data so vectorized code paths execute, :40-57), and
``testBufferChunksEqual/Close`` (:67-93).
"""

from __future__ import annotations

import numpy as np

from pothoscomms_tpu.core.dtypes import DType


def stretch_vector(values, factor: int) -> np.ndarray:
    """Repeat each element ``factor`` times (reference
    common/Testing.hpp:40-57)."""
    arr = np.asarray(values)
    return np.repeat(arr, factor, axis=0)


def to_complex_int(values, dtype) -> np.ndarray:
    """Convert complex python/numpy values to the trailing-(re,im) integer
    representation used for complex-int DTypes."""
    dtype = DType.parse(dtype)
    arr = np.asarray(values)
    out = np.stack([arr.real, arr.imag], axis=-1)
    return out.astype(dtype.scalar.np)


def from_complex_int(arr) -> np.ndarray:
    """Trailing-(re,im) int array -> numpy complex128 (for comparisons)."""
    arr = np.asarray(arr)
    return arr[..., 0].astype(np.float64) + 1j * arr[..., 1].astype(np.float64)


def assert_buffers_equal(expected, actual, msg=""):
    expected = np.asarray(expected)
    actual = np.asarray(actual)
    assert expected.shape == actual.shape, (
        f"{msg} shape mismatch: expected {expected.shape} got {actual.shape}"
    )
    np.testing.assert_array_equal(actual, expected, err_msg=msg)


def assert_buffers_close(expected, actual, epsilon=1e-6, msg=""):
    expected = np.asarray(expected)
    actual = np.asarray(actual)
    assert expected.shape == actual.shape, (
        f"{msg} shape mismatch: expected {expected.shape} got {actual.shape}"
    )
    np.testing.assert_allclose(actual, expected, atol=epsilon, rtol=0, err_msg=msg)
