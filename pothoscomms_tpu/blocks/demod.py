"""Demodulation blocks (reference: demod/ module, SURVEY.md §2.6).

/comms/freq_demod — FM discriminator out[i] = arg(in[i] * conj(in[i-1]))
with a one-sample carry; the float path uses arg(), the fixed-point path
maps the angle to full-turn units via the Q15 fxpt_atan2
(reference: demod/FreqDemod.cpp:49-71, functions/FxptHelpers.hpp:14-29).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from pothoscomms_tpu.core.block import Block
from pothoscomms_tpu.core.dtypes import DType
from pothoscomms_tpu.core.registry import register_block
from pothoscomms_tpu.ops import cint
from pothoscomms_tpu.ops.fxpt import fxpt_atan2


@register_block("/comms/freq_demod", "/blocks/freq_demod")
class FreqDemod(Block):
    DOC = {
        "category": "/Demod",
        "keywords": ["fm", "demod", "discriminator", "frequency"],
        "params": {},
    }

    def __init__(self, dtype="complex_float32"):
        super().__init__()
        self.dtype = DType.parse(dtype)
        if not self.dtype.is_complex:
            raise ValueError("freq_demod requires a complex dtype")
        if self.dtype.kind == "uint":
            raise ValueError("unsupported dtype")
        self.out_dtype = self.dtype.scalar
        self.setup_input(0, self.dtype)
        self.setup_output(0, self.out_dtype)
        self.activate()

    def activate(self):
        # _prev holds conj(previous sample); reference starts at 0
        if self.dtype.is_complex_int:
            self._prev = np.zeros(2, self.dtype.scalar.np)
        else:
            self._prev = np.zeros((), self.dtype.np)

    def work(self):
        port = self.input(0)
        n = port.elements()
        if n == 0:
            return
        buf = np.asarray(port.buffer(n))
        if self.dtype.is_float:
            prev_conj = np.concatenate([[self._prev], np.conj(buf[:-1])])
            diff = buf * prev_conj
            out = np.angle(diff).astype(self.out_dtype.np)
            self._prev = np.conj(buf[-1])
        else:
            # integer path: product in C complex<int> semantics, then
            # fxpt_atan2 on int16-truncated components
            prev_conj = np.concatenate(
                [self._prev[None, :],
                 np.stack([buf[:-1, 0], -buf[:-1, 1]], axis=-1)]
            )
            prod = np.asarray(
                cint.mul(jnp.asarray(buf), jnp.asarray(prev_conj)))
            re16 = prod[:, 0].astype(np.int16)
            im16 = prod[:, 1].astype(np.int16)
            u16 = np.asarray(fxpt_atan2(im16, re16))
            out = u16.astype(self.out_dtype.np)  # Type(u16out) C cast
            self._prev = np.asarray([buf[-1, 0], -buf[-1, 1]],
                                    self.dtype.scalar.np)
        port.consume(n)
        self.output(0).post(out)

    def device_core(self, channels: int):
        """Fused-chain core: FM discriminator over planar [C, T, 2] with a
        one-sample carry (parallel/chain.freq_demod_planar)."""
        from pothoscomms_tpu.parallel.chain import freq_demod_planar

        carry0 = jnp.zeros((channels, 1, 2), jnp.float32)

        def step(carry, x):
            y, last = freq_demod_planar(x, carry)
            return last, y

        return carry0, step

    # -- auto-fusion protocol (core/fusion.py): streaming keeps
    # conj(previous sample); the fused carry is the sample itself.
    def fuse_ready(self) -> bool:
        return self.dtype.is_float and self.dtype.bits == 32

    def fuse_export(self, channels: int):
        _, step = self.device_core(channels)
        last = np.conj(self._prev)
        carry = jnp.asarray(
            np.array([[[last.real, last.imag]]], np.float32))
        return carry, step

    def fuse_import(self, carry) -> None:
        c = np.asarray(carry)[0, 0]
        self._prev = np.conj(
            np.asarray(c[0] + 1j * c[1], self.dtype.np))
