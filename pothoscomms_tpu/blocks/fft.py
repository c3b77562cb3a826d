"""FFT block (reference: fft/ module, SURVEY.md §2.2).

Scaling contract (from the reference's kissfft configuration and tests):

- complex float forward: plain DFT, numpy semantics (fft/TestFFT.cpp:13-29).
- complex float inverse: UNnormalized — round-trip gains a factor of N
  (fft/TestFFT.cpp:79-80 checks ifft(fft(x)) == x*N), matching kissfft.
- complex int16 (FIXED_POINT=16 kiss_fft, fft/CMakeLists.txt:14-20):
  forward output is scaled by 1/N (fft/TestFFT.cpp:128-133); inverse is the
  exactly-normalized inverse DFT (TestFFT.cpp:152-156: ifft(N*scaled) == x).

Instead of the reference's one-transform-per-work loop
(fft/FFT.cpp:61-72), all complete numBins windows queued on the input are
batched into a single [k, numBins] jnp.fft call — one XLA fft op over the
batch. The int16 path computes in complex64 (far more precise than 16-bit
kiss_fft butterflies) and rounds on output.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from functools import partial

from pothoscomms_tpu.core.block import Block
from pothoscomms_tpu.core.dtypes import DType
from pothoscomms_tpu.core.registry import register_block


@partial(jax.jit, static_argnames=("inverse",))
def _fft_float(x, inverse: bool):
    # x: [k, numBins] complex; inverse is kissfft-style unnormalized
    if inverse:
        n = x.shape[-1]
        return jnp.fft.ifft(x, axis=-1) * n
    return jnp.fft.fft(x, axis=-1)


@partial(jax.jit, static_argnames=("inverse",))
def _fft_int16(x_ri, inverse: bool):
    # x_ri: [k, numBins, 2] int16 -> complex64 compute -> rounded int16
    x = x_ri[..., 0].astype(jnp.float32) + 1j * x_ri[..., 1].astype(jnp.float32)
    n = x.shape[-1]
    if inverse:
        y = jnp.fft.ifft(x, axis=-1)  # includes 1/n: matches TestFFT int16
    else:
        y = jnp.fft.fft(x, axis=-1) / n
    out = jnp.stack([jnp.round(y.real), jnp.round(y.imag)], axis=-1)
    return out.astype(jnp.int16)


@register_block("/comms/fft")
class FFTBlock(Block):
    """Forward/inverse complex FFT over numBins-sized windows
    (reference: fft/FFT.cpp)."""

    DOC = {
        "category": "/FFT",
        "keywords": ["fft", "dft", "fourier", "transform"],
        "params": {
            "num_bins": {"label": "Num FFT Bins", "default": 1024,
                         "widget": "ComboBox(editable=true)",
                         "options": [{"label": str(1 << p),
                                      "value": 1 << p}
                                     for p in range(4, 13)]},
            "inverse": {"label": "Inverse FFT", "default": False,
                        "widget": "ToggleSwitch"},
        },
    }

    def __init__(self, dtype="complex_float32", num_bins: int = 1024,
                 inverse: bool = False):
        super().__init__()
        self.dtype = DType.parse(dtype)
        if not self.dtype.is_complex:
            raise ValueError("fft: complex dtypes only")
        if self.dtype.is_integer and self.dtype.bits != 16:
            raise ValueError("fft: integer path supports complex_int16 only "
                             "(reference FFTAux.h:29-48)")
        self.num_bins = int(num_bins)
        self.inverse = bool(inverse)
        self.setup_input(0, self.dtype)
        self.setup_output(0, self.dtype)
        self.input(0).set_reserve(self.num_bins)

    def work(self):
        port = self.input(0)
        nb = self.num_bins
        k = port.elements() // nb
        if k == 0:
            return
        buf = port.buffer(k * nb)
        if self.dtype.is_integer:
            x = np.asarray(buf).reshape(k, nb, 2)
            out = np.asarray(_fft_int16(x, self.inverse)).reshape(k * nb, 2)
        else:
            x = np.asarray(buf).reshape(k, nb)
            out = np.asarray(
                _fft_float(x, self.inverse), dtype=self.dtype.np
            ).reshape(k * nb)
        port.consume(k * nb)
        self.output(0).post(out)

    def device_core(self, channels: int):
        """Fused-chain core (terminal stage): windowed matmul FFT. Input
        [C, T, 2] planar with T a multiple of numBins; output
        [C, T/numBins, numBins, 2] spectra. The complex_int16 path
        applies the kiss FIXED_POINT contract (1/N forward, normalized
        inverse) + rounding INSIDE the program with the same complex64
        ``jnp.fft`` as the streaming path (_fft_int16), so round() sees
        identical values and the integer-valued plane matches the
        streaming output bit for bit."""
        from pothoscomms_tpu.parallel.fft import fft_planar

        nb, inverse = self.num_bins, self.inverse
        fixed = self.dtype.is_integer

        def step(carry, x):
            c, t, _ = x.shape
            frames = x.reshape(c * (t // nb), nb, 2)
            if fixed:
                z = frames[..., 0] + 1j * frames[..., 1]
                zf = jnp.fft.ifft(z, axis=-1) if inverse \
                    else jnp.fft.fft(z, axis=-1) / nb
                spec = jnp.stack([jnp.round(zf.real), jnp.round(zf.imag)],
                                 axis=-1)
            else:
                spec = fft_planar(frames, nb, inverse)
            return carry, spec.reshape(c, t // nb, nb, 2)

        return (), step

    # -- auto-fusion protocol (core/fusion.py) -------------------------- #
    fuse_kind = "fft"  # frames out: terminates a fused run

    def fuse_retained(self):
        return None  # any sub-frame leftover is absorbed into the carry

    def fuse_ready(self) -> bool:
        # the queued sub-frame leftover becomes the carry; a full frame
        # still queued (e.g. congestion skipped work()) must drain first
        return (self.dtype.bits in (16, 32)
                and self.input(0).elements() < self.num_bins)

    def fuse_export(self, channels: int):
        """Streaming state = the sub-frame leftover queued on the input
        port (work() only consumes whole numBins windows); it becomes a
        [C, r, 2] carry so fused quanta stay frame-phase-accurate."""
        port = self.input(0)
        r = port.elements()
        nb = self.num_bins
        assert r < nb
        if r == 0:
            # still use the leftover-capable step: an upstream COLD
            # FIR's first quantum is K-1 short, so mid-stream lengths
            # are not always frame-aligned (the sub-frame tail rides
            # the carry; its shape re-keys the step cache)
            left = jnp.zeros((channels, 0, 2), jnp.float32)
        else:
            parts = port.take(r)
            arr = np.concatenate([np.asarray(p) for p in parts])
            if self.dtype.is_integer:  # storage already [r, 2] int16
                left = jnp.asarray(arr.astype(np.float32))[None]
            else:
                left = jnp.asarray(np.stack(
                    [arr.real, arr.imag], -1).astype(np.float32))[None]
        _, core = self.device_core(channels)

        def step(carry, x):
            ext = jnp.concatenate([carry, x], axis=1)  # [C, r+T, 2]
            m = ext.shape[1] // nb
            _, spec = core(None, ext[:, : m * nb])
            return ext[:, m * nb:], spec

        return left, step

    def fuse_import(self, carry) -> None:
        if carry is None or (isinstance(carry, tuple) and not carry):
            return
        c = np.asarray(carry)[0]
        if c.shape[0] == 0:
            return
        if self.dtype.is_integer:
            arr = np.rint(c).astype(self.dtype.np)
        else:
            arr = (c[..., 0] + 1j * c[..., 1]).astype(self.dtype.np)
        self.input(0).push_front_buffer(arr)
