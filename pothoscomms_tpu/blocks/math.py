"""Elementwise math blocks (reference: math/ module, SURVEY.md §2.1).

All 25 registered factories of the reference math module. Each block wraps a
functional core from :mod:`pothoscomms_tpu.ops.elementwise` — a pure jnp
function jitted once per block; under the fused-chain compiler these cores
fuse with neighbors into a single XLA program (the replacement for the
reference's per-block SIMD dispatch, math/SIMD/*).
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import jax
import jax.numpy as jnp

from pothoscomms_tpu.core.block import Block
from pothoscomms_tpu.core.dtypes import DType
from pothoscomms_tpu.core.qformat import float_to_q, q_dtype_for
from pothoscomms_tpu.core.registry import register_block
from pothoscomms_tpu.ops import cint, elementwise as ew


def _as_np(x):
    return np.asarray(x)


class ElementwiseBlock(Block):
    """Generic N-in/M-out elementwise block: work() = jitted core over
    min-available elements (reference pattern: math/Arithmetic.cpp:204-231).

    Every 1-in/1-out float32 instance also implements the auto-fusion
    protocol (core/fusion.py) so chains containing an abs/sinc/trig/...
    hop stay fused — the reference bar is that EVERY math block gets its
    fast kernel from the scheduler automatically
    (math/Arithmetic.cpp:46-67). Real-f32 blocks reuse the numpy-dtype
    core directly on the planar [C, T] block; complex-f32 blocks need an
    explicit ``planar_core`` over [C, T, 2] (re, im) planes because the
    fused stream layout is planar f32."""

    def __init__(self, dtype, core: Callable, n_in=1, n_out=1, out_dtype=None,
                 planar_core: Callable = None):
        super().__init__()
        self.dtype = DType.parse(dtype)
        self.out_dtype = DType.parse(out_dtype) if out_dtype else self.dtype
        for i in range(n_in):
            self.setup_input(i, self.dtype)
        for i in range(n_out):
            self.setup_output(i, self.out_dtype)
        self._raw_core = core
        self._planar_core = planar_core
        self._core = self.jit(core)
        self._n_in = n_in
        self._n_out = n_out

    def work(self):
        elems = self.clamp_work_size(
            min(self.input(i).elements() for i in range(self._n_in))
        )
        if elems == 0:
            return
        ins = [self.input(i).buffer(elems) for i in range(self._n_in)]
        outs = self._core(*ins)
        if self._n_out == 1:
            outs = (outs,)
        for i in range(self._n_in):
            self.input(i).consume(elems)
        for i in range(self._n_out):
            self.output(i).post(_as_np(outs[i]))

    # -- auto-fusion protocol (core/fusion.py): stateless elementwise -- #
    def _fuse_planar_core(self):
        """The core applied on the fused (planar float32) path, or None
        if this instance cannot fuse. A real-f32 -> real-f32 core is
        dtype-generic jnp code and runs on the planar block unchanged;
        complex handling must be supplied as ``planar_core``. N-input
        instances (Comparator, Beta, ...) may HEAD a fan-in fused
        segment (core/fusion.py pulls an aligned quantum per port);
        an int8 output (comparator verdicts) rides as 0/1 f32 and casts
        on materialization."""
        if self._n_out != 1:
            return None
        if self._n_in == 1 and self._planar_core is not None:
            return self._planar_core
        f32 = (self.dtype.is_float and self.dtype.bits == 32
               and not self.dtype.is_complex)
        out_ok = ((self.out_dtype.is_float and self.out_dtype.bits == 32
                   and not self.out_dtype.is_complex)
                  or (self.out_dtype.is_integer
                      and not self.out_dtype.is_complex))
        if f32 and out_ok:
            return self._raw_core
        return None

    def fuse_ready(self) -> bool:
        return self._fuse_planar_core() is not None

    def fuse_label_adjust(self, lb):
        """Elementwise blocks propagate labels verbatim and their
        compute ignores labels — safe to carry labels through a fused
        quantum (single-input runs only; fan-in heads stay opaque)."""
        return lb

    def fuse_export(self, channels: int):
        f = self._fuse_planar_core()
        if self._n_in == 1:
            def step(carry, x):
                return carry, jnp.asarray(f(x), jnp.float32)
        else:
            def step(carry, xs):
                return carry, jnp.asarray(f(*xs), jnp.float32)

        return (), step

    def fuse_import(self, carry) -> None:
        pass


# --------------------------------------------------------------------- #
# /comms/arithmetic — N-ary elementwise chain with preload for feedback
# loops (reference: math/Arithmetic.cpp)
# --------------------------------------------------------------------- #
@register_block("/comms/arithmetic", "/blocks/arithmetic")
def arithmetic_factory(dtype, operation: str):
    return Arithmetic(dtype, operation)


class Arithmetic(Block):
    DOC = {
        "category": "/Math",
        "keywords": ["arithmetic", "add", "subtract", "multiply",
                     "divide"],
        "factory_args": {
            "operation": {
                "label": "Operation",
                "options": [{"label": o.title(), "value": o} for o in
                            ("ADD", "SUB", "MUL", "DIV")],
                "default": "ADD",
            },
        },
        "params": {
            "num_inputs": {"label": "Num Inputs", "default": 2,
                           "widget": "SpinBox(minimum=2)"},
            "preload": {"label": "Preload", "default": [],
                        "desc": "Zero-sample preload per input port "
                                "(feedback topologies)."},
        },
    }

    def __init__(self, dtype, operation: str):
        super().__init__()
        self.dtype = DType.parse(dtype)
        self._operation = operation
        self._fcn = ew.binary_arith_fn(self.dtype, operation)
        self.setup_input(0, self.dtype)
        self.setup_input(1, self.dtype)  # requires >= 2 inputs
        self.setup_output(0, self.dtype)
        self._preload: List[int] = []
        self._num_inline_buffers = 0

        def chain(*ins):
            acc = ins[0]
            for x in ins[1:]:
                acc = self._fcn(acc, x)
            return acc

        # donate in0 so XLA writes the output in place over the first
        # input's buffer — the equivalent of the reference's
        # setReadBeforeWrite in-place inlining (math/Arithmetic.cpp:165-168)
        self._chain = self.jit(chain, donate_argnums=(0,))

    def set_num_inputs(self, num_inputs: int):
        if num_inputs < 2:
            raise ValueError("Arithmetic requires inputs >= 2")
        for i in range(len(self.inputs), num_inputs):
            self.setup_input(i, self.dtype)

    def set_preload(self, preload: List[int]):
        self.set_num_inputs(max(2, len(preload)))
        self._preload = list(preload)

    def preload(self) -> List[int]:
        return self._preload

    def get_num_inline_buffers(self) -> int:
        return self._num_inline_buffers

    def activate(self):
        # pad chosen inputs with zeros for feedback topologies
        # (reference: math/Arithmetic.cpp:191-202)
        for i, n in enumerate(self._preload):
            if n == 0:
                continue
            shape = (n,) + self.dtype.storage_shape_suffix
            self.input(i).push_buffer(np.zeros(shape, self.dtype.np))

    def work(self):
        ports = [self.input(i) for i in range(len(self.inputs))]
        elems = self.clamp_work_size(min(p.elements() for p in ports))
        if elems == 0:
            return
        bufs = [p.buffer(elems) for p in ports]
        x0 = jnp.asarray(bufs[0])
        out = self._chain(x0, *bufs[1:])
        if x0.is_deleted():
            # XLA actually consumed in0's device buffer for the output
            # (the reference asserts this real inlining,
            # math/TestArithmeticBlocks.cpp:381-383)
            self._num_inline_buffers += 1
        for p in ports:
            p.consume(elems)
        self.output(0).post(_as_np(out))

    def propagate_labels(self, port, labels):
        # feedback (preloaded) ports do not propagate labels
        # (reference: math/Arithmetic.cpp:233-240)
        idx = int(port.name)
        if idx < len(self._preload) and self._preload[idx] > 0:
            return
        super().propagate_labels(port, labels)

    # -- auto-fusion protocol: N-ary fan-in HEAD (core/fusion.py) ------- #
    # The flagship reference block (math/Arithmetic.cpp:204-231): the
    # fused segment pulls an aligned quantum from EVERY input port and
    # reduces on device; complex streams fold via planar mul/div.
    def fuse_ready(self) -> bool:
        return self.dtype.is_float and self.dtype.scalar.bits == 32

    def fuse_export(self, channels: int):
        op = self._operation
        if self.dtype.is_complex:
            def pfn(a, b):
                ar, ai = a[..., 0], a[..., 1]
                br, bi = b[..., 0], b[..., 1]
                if op == "ADD":
                    return a + b
                if op == "SUB":
                    return a - b
                if op == "MUL":
                    return jnp.stack([ar * br - ai * bi,
                                      ar * bi + ai * br], axis=-1)
                den = br * br + bi * bi
                return jnp.stack([(ar * br + ai * bi) / den,
                                  (ai * br - ar * bi) / den], axis=-1)
        else:
            pfn = self._fcn

        def step(carry, xs):
            acc = xs[0]
            for x in xs[1:]:
                acc = pfn(acc, x)
            return carry, acc

        return (), step

    def fuse_import(self, carry) -> None:
        pass


# --------------------------------------------------------------------- #
# /comms/const_arithmetic (reference: math/ConstArithmetic.cpp)
# --------------------------------------------------------------------- #
_CONST_OP_KEYS = {
    "X+K": "X_PLUS_K",
    "X-K": "X_MINUS_K",
    "K-X": "K_MINUS_X",
    "X*K": "X_MULT_K",
    "X/K": "X_DIV_K",
    "K/X": "K_DIV_X",
}


@register_block("/comms/const_arithmetic")
def const_arithmetic_factory(dtype, operation: str, constant):
    return ConstArithmetic(dtype, operation, constant)


class ConstArithmetic(Block):
    DOC = {
        "category": "/Math",
        "keywords": ["arithmetic", "constant", "scale", "offset"],
        "factory_args": {
            "operation": {
                "label": "Operation",
                "options": [{"label": o, "value": o} for o in
                            ("X+K", "X-K", "K-X", "X*K", "X/K", "K/X")],
                "default": "X+K",
            },
        },
        "params": {
            "constant": {"label": "Constant", "default": 0.0},
        },
    }

    def __init__(self, dtype, operation, constant):
        super().__init__()
        self.dtype = DType.parse(dtype)
        key = _CONST_OP_KEYS.get(operation, operation)
        self._op_key = key
        self._fcn = self.jit(ew.const_arith_fn(self.dtype, key))
        self.setup_input(0, self.dtype)
        self.setup_output(0, self.dtype)
        self.set_constant(constant)

    def set_constant(self, constant):
        if self.dtype.is_complex_int:
            c = np.asarray(
                [np.real(constant), np.imag(constant)], self.dtype.scalar.np
            )
        else:
            c = np.asarray(constant, self.dtype.np)
        self._constant = c
        self._bump_fuse_epoch()

    def constant(self):
        if self.dtype.is_complex_int:
            return complex(self._constant[0], self._constant[1])
        return self._constant[()]

    def work(self):
        port = self.input(0)
        elems = port.elements()
        if elems == 0:
            return
        out = self._fcn(port.buffer(elems), self._constant)
        port.consume(elems)
        self.output(0).post(_as_np(out))

    # -- auto-fusion protocol: stateless planar const-arith ------------- #
    def fuse_ready(self) -> bool:
        return self.dtype.is_float and self.dtype.bits == 32

    def fuse_export(self, channels: int):
        op = self._op_key
        if not self.dtype.is_complex:
            k = jnp.float32(self._constant)
            base = ew.const_arith_fn(self.dtype, op)

            def step(carry, x):
                return carry, base(x, k)

            return (), step
        # complex f32: constant applied in planar (re, im) form
        c = complex(self._constant)
        kr, ki = jnp.float32(c.real), jnp.float32(c.imag)
        kvec = jnp.asarray([c.real, c.imag], jnp.float32)

        def cmul(x, ar, ai):
            re = x[..., 0] * ar - x[..., 1] * ai
            im = x[..., 0] * ai + x[..., 1] * ar
            return jnp.stack([re, im], axis=-1)

        if op == "X_PLUS_K":
            f = lambda x: x + kvec
        elif op == "X_MINUS_K":
            f = lambda x: x - kvec
        elif op == "K_MINUS_X":
            f = lambda x: kvec - x
        elif op == "X_MULT_K":
            f = lambda x: cmul(x, kr, ki)
        elif op == "X_DIV_K":
            inv = 1.0 / (c if c != 0 else 1.0)
            ir, ii = jnp.float32(inv.real), jnp.float32(inv.imag)
            f = lambda x: cmul(x, ir, ii)
        else:  # K_DIV_X: K * conj(x) / |x|^2
            def f(x):
                d = x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]
                d = jnp.where(d == 0, jnp.float32(1.0), d)
                re = (kr * x[..., 0] + ki * x[..., 1]) / d
                im = (ki * x[..., 0] - kr * x[..., 1]) / d
                return jnp.stack([re, im], axis=-1)

        def step(carry, x):
            return carry, f(x)

        return (), step

    def fuse_import(self, carry) -> None:
        pass


# --------------------------------------------------------------------- #
# /comms/scale — Q-format multiply with label-driven factor updates
# (reference: math/Scale.cpp)
# --------------------------------------------------------------------- #
@register_block("/comms/scale", "/blocks/scale")
def scale_factory(dtype):
    return Scale(dtype)


class Scale(Block):
    DOC = {
        "category": "/Math",
        "keywords": ["scale", "multiply", "gain"],
        "params": {
            "factor": {"label": "Factor", "default": 0.0},
            "label_id": {"label": "Label ID", "default": "",
                         "preview": "valid",
                         "desc": "Label ID whose data sets the factor "
                                 "sample-accurately mid-stream."},
        },
    }

    def __init__(self, dtype):
        super().__init__()
        self.dtype = DType.parse(dtype)
        self._qdtype = q_dtype_for(self.dtype)
        self.setup_input(0, self.dtype)
        self.setup_output(0, self.dtype)
        self._label_id = ""
        self.set_factor(0.0)

        qscalar = self._qdtype.scalar
        half = qscalar.bits // 2
        out_np = self.dtype.np
        is_int = self.dtype.is_integer

        def kernel(x, factor_q):
            # tmp = factor_q * Q(x); out = fromQ(tmp)
            # (reference math/Scale.cpp:15-23)
            if is_int:
                tmp = x.astype(qscalar.np) * factor_q
                return (tmp >> half).astype(out_np)
            return (x * factor_q).astype(out_np)

        self._kernel = self.jit(kernel)

    def set_factor(self, factor: float):
        self._factor = float(factor)
        # ScaleType is the real scalar Q type even for complex data
        self._factor_scaled = float_to_q(self._factor, self._qdtype.scalar)
        self._bump_fuse_epoch()

    def get_factor(self) -> float:
        return self._factor

    def set_label_id(self, label_id: str):
        self._label_id = label_id

    def get_label_id(self) -> str:
        return self._label_id

    def _scan_labels(self, port, elems: int) -> int:
        """Apply label-driven reconfiguration; returns (possibly truncated)
        work size (reference: math/Scale.cpp:104-122)."""
        if not self._label_id:
            return elems
        for lb in sorted(port.labels, key=lambda l: l.index):
            if lb.index >= elems:
                break
            if lb.id == self._label_id:
                if lb.index == 0:
                    self.set_factor(float(lb.data))
                else:
                    return lb.index
        return elems

    def work(self):
        port = self.input(0)
        elems = self.clamp_work_size(port.elements())
        if elems == 0:
            return
        elems = self._scan_labels(port, elems)
        out = self._kernel(port.buffer(elems), self._factor_scaled)
        port.consume(elems)
        self.output(0).post(_as_np(out))

    def device_core(self, channels: int):
        """Fused-chain core (parallel/compiler.py): y = x * factor over a
        planar float32 [C, T(, 2)] block; stateless."""
        factor = jnp.float32(self._factor)

        def step(carry, x):
            return carry, x * factor

        return (), step

    # -- auto-fusion protocol (core/fusion.py): stateless; label-driven
    # factor updates arrive as labels, which disengage the segment.
    def fuse_ready(self) -> bool:
        return self.dtype.is_float and self.dtype.bits == 32

    def fuse_export(self, channels: int):
        return self.device_core(channels)

    def fuse_import(self, carry) -> None:
        pass


# --------------------------------------------------------------------- #
# /comms/rotate — complex multiply by e^{j phase} in Q format
# (reference: math/Rotate.cpp)
# --------------------------------------------------------------------- #
@register_block("/comms/rotate")
def rotate_factory(dtype):
    return Rotate(dtype)


class Rotate(Block):
    DOC = {
        "category": "/Math",
        "keywords": ["rotate", "phasor", "multiply"],
        "params": {
            "phase": {"label": "Phase", "default": 0.0,
                      "units": "radians"},
            "label_id": {"label": "Label ID", "default": "",
                         "preview": "valid"},
        },
    }

    def __init__(self, dtype):
        super().__init__()
        self.dtype = DType.parse(dtype)
        if not self.dtype.is_complex:
            raise ValueError("rotate requires a complex dtype")
        self._qdtype = q_dtype_for(self.dtype)
        self.setup_input(0, self.dtype)
        self.setup_output(0, self.dtype)
        self._label_id = ""

        qscalar = self._qdtype.scalar
        half = qscalar.bits // 2
        out_np = self.dtype.np
        is_int = self.dtype.is_integer

        def kernel(x, phasor):
            if is_int:
                xq = x.astype(qscalar.np)
                prod = cint.mul(xq, phasor.astype(qscalar.np))
                return (prod >> half).astype(out_np)
            return (x * phasor).astype(out_np)

        self._kernel = self.jit(kernel)
        self.set_phase(0.0)

    def set_phase(self, phase: float):
        self._phase = float(phase)
        phasor = np.exp(1j * self._phase)
        self._phasor = float_to_q(phasor, self._qdtype)
        self._bump_fuse_epoch()

    def get_phase(self) -> float:
        return self._phase

    def set_label_id(self, label_id: str):
        self._label_id = label_id

    def get_label_id(self) -> str:
        return self._label_id

    def work(self):
        port = self.input(0)
        elems = port.elements()
        if elems == 0:
            return
        if self._label_id:
            for lb in sorted(port.labels, key=lambda l: l.index):
                if lb.index >= elems:
                    break
                if lb.id == self._label_id:
                    if lb.index == 0:
                        self.set_phase(float(lb.data))
                    else:
                        elems = lb.index
                        break
        out = self._kernel(port.buffer(elems), self._phasor)
        port.consume(elems)
        self.output(0).post(_as_np(out))

    # -- auto-fusion protocol: stateless planar complex rotate ---------- #
    def fuse_ready(self) -> bool:
        return self.dtype.is_float and self.dtype.bits == 32

    def fuse_export(self, channels: int):
        ph = np.exp(1j * self._phase)
        pr, pi = jnp.float32(ph.real), jnp.float32(ph.imag)

        def step(carry, x):
            re = x[..., 0] * pr - x[..., 1] * pi
            im = x[..., 0] * pi + x[..., 1] * pr
            return carry, jnp.stack([re, im], axis=-1)

        return (), step

    def fuse_import(self, carry) -> None:
        pass


# --------------------------------------------------------------------- #
# Comparators (reference: math/Comparator.cpp, math/ConstComparator.cpp)
# --------------------------------------------------------------------- #
@register_block("/comms/comparator")
def comparator_factory(dtype, operation: str):
    core = ew.comparator_fn(operation)
    return ElementwiseBlock(dtype, core, n_in=2, out_dtype="int8")


@register_block("/comms/const_comparator")
def const_comparator_factory(dtype, operation: str, constant=0):
    dt = DType.parse(dtype)
    cmp = ew.comparator_fn(operation)
    blk = ConstComparator(dt, cmp, constant)
    return blk


class ConstComparator(Block):
    def __init__(self, dtype, cmp, constant):
        super().__init__()
        self.dtype = DType.parse(dtype)
        self.setup_input(0, self.dtype)
        self.setup_output(0, DType.parse("int8"))
        self._raw_cmp = cmp
        self._cmp = self.jit(cmp)
        self.set_constant(constant)

    def set_constant(self, constant):
        self._constant = np.asarray(constant, self.dtype.np)
        self._bump_fuse_epoch()

    # -- auto-fusion protocol: f32 stream -> 0/1 planar (int8 tail) ----- #
    def fuse_ready(self) -> bool:
        return (self.dtype.is_float and self.dtype.bits == 32
                and not self.dtype.is_complex)

    def fuse_export(self, channels: int):
        k = jnp.float32(self._constant)
        cmp = self._raw_cmp

        def step(carry, x):
            # device path is f32-only: emit 0.0/1.0; the DeviceChunk's
            # int8 dtype casts on materialization
            return carry, cmp(x, k).astype(jnp.float32)

        return (), step

    def fuse_import(self, carry) -> None:
        pass

    def constant(self):
        return self._constant[()]

    def work(self):
        port = self.input(0)
        elems = port.elements()
        if elems == 0:
            return
        out = self._cmp(port.buffer(elems), self._constant)
        port.consume(elems)
        self.output(0).post(_as_np(out))


# --------------------------------------------------------------------- #
# Simple unary blocks
# --------------------------------------------------------------------- #
def _planar_abs(x):
    return jnp.sqrt(x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1])


def _planar_angle(x):
    return jnp.arctan2(x[..., 1], x[..., 0])


def _planar_conj(x):
    return jnp.stack([x[..., 0], -x[..., 1]], axis=-1)


@register_block("/comms/abs")
def abs_factory(dtype):
    dt = DType.parse(dtype)
    if dt.kind == "uint":
        raise ValueError("abs: unsigned types unsupported (reference matrix)")
    out = dt.scalar if dt.is_complex else dt
    planar = _planar_abs if (dt.is_complex and dt.is_float
                             and dt.bits == 32) else None
    return ElementwiseBlock(dt, ew.abs_fn(dt), out_dtype=out,
                            planar_core=planar)


@register_block("/comms/angle")
def angle_factory(dtype):
    dt = DType.parse(dtype)
    if not dt.is_complex:
        raise ValueError("angle requires a complex dtype")
    planar = _planar_angle if (dt.is_float and dt.bits == 32) else None
    return ElementwiseBlock(dt, ew.angle_fn(dt), out_dtype=dt.scalar,
                            planar_core=planar)


@register_block("/comms/conjugate")
def conjugate_factory(dtype):
    dt = DType.parse(dtype)
    if not dt.is_complex:
        raise ValueError("conjugate requires a complex dtype")
    planar = _planar_conj if (dt.is_float and dt.bits == 32) else None
    return ElementwiseBlock(dt, ew.conjugate_fn(dt), planar_core=planar)


@register_block("/comms/sinc")
def sinc_factory(dtype):
    dt = DType.parse(dtype)
    if not dt.is_float or dt.is_complex:
        raise ValueError("sinc: float types only")
    return ElementwiseBlock(dt, ew.unary_fn(dt, "sinc"))


@register_block("/comms/sigmoid")
def sigmoid_factory(dtype):
    dt = DType.parse(dtype)
    if not dt.is_float or dt.is_complex:
        raise ValueError("sigmoid: float types only")
    return ElementwiseBlock(dt, ew.unary_fn(dt, "sigmoid"))


@register_block("/comms/rsqrt")
def rsqrt_factory(dtype):
    dt = DType.parse(dtype)
    if not dt.is_float or dt.is_complex:
        raise ValueError("rsqrt: float types only")
    return ElementwiseBlock(dt, ew.rsqrt_fn(dt))


@register_block("/comms/gamma")
def gamma_factory(dtype):
    dt = DType.parse(dtype)
    if not dt.is_float or dt.is_complex:
        raise ValueError("gamma: float types only")
    return ElementwiseBlock(dt, ew.unary_fn(dt, "gamma"))


@register_block("/comms/lngamma")
def lngamma_factory(dtype):
    dt = DType.parse(dtype)
    if not dt.is_float or dt.is_complex:
        raise ValueError("lngamma: float types only")
    return ElementwiseBlock(dt, ew.unary_fn(dt, "lngamma"))


@register_block("/comms/erf")
def erf_factory(dtype):
    dt = DType.parse(dtype)
    if not dt.is_float or dt.is_complex:
        raise ValueError("erf: float types only")
    return ElementwiseBlock(dt, ew.unary_fn(dt, "erf"))


@register_block("/comms/erfc")
def erfc_factory(dtype):
    dt = DType.parse(dtype)
    if not dt.is_float or dt.is_complex:
        raise ValueError("erfc: float types only")
    return ElementwiseBlock(dt, ew.unary_fn(dt, "erfc"))


@register_block("/comms/beta")
def beta_factory(dtype):
    dt = DType.parse(dtype)
    if not dt.is_float or dt.is_complex:
        raise ValueError("beta: float types only")
    return ElementwiseBlock(dt, ew.beta_fn(dt), n_in=2)


# --------------------------------------------------------------------- #
# Trigonometric — 24 ops in one block (reference: math/Trigonometric.cpp)
# --------------------------------------------------------------------- #
@register_block("/comms/trigonometric")
def trig_factory(dtype, operation: str):
    return Trigonometric(dtype, operation)


class Trigonometric(ElementwiseBlock):
    DOC = {
        "category": "/Math",
        "keywords": ["trig", "sin", "cos", "tan", "hyperbolic"],
        "params": {
            "operation": {
                "label": "Operation",
                "options": [{"label": o.title(), "value": o}
                            for o in sorted(ew.TRIG_OPS)],
                "default": "SIN",
            },
        },
    }

    def __init__(self, dtype, operation):
        dt = DType.parse(dtype)
        if not dt.is_float or dt.is_complex:
            raise ValueError("trigonometric: float types only")
        self._op = None
        super().__init__(dt, lambda x: x)
        self.set_operation(operation)

    def set_operation(self, op: str):
        if op not in ew.TRIG_OPS:
            raise ValueError(f"invalid trig operation {op}")
        self._op = op
        self._raw_core = ew.TRIG_OPS[op]
        self._core = self.jit(self._raw_core)
        self._bump_fuse_epoch()


# --------------------------------------------------------------------- #
# Pow / roots (reference: math/Pow.cpp, math/Root.cpp)
# --------------------------------------------------------------------- #
class _ParamUnary(Block):
    """Unary block with one runtime scalar parameter."""

    param_name = "param"

    def __init__(self, dtype, core2, param):
        super().__init__()
        self.dtype = DType.parse(dtype)
        self.setup_input(0, self.dtype)
        self.setup_output(0, self.dtype)
        self._raw_core2 = core2
        self._core2 = self.jit(core2)
        self._param = np.asarray(param, np.float64)

    def set_param(self, value) -> None:
        self._param = np.asarray(value, np.float64)
        self._bump_fuse_epoch()

    def work(self):
        port = self.input(0)
        elems = port.elements()
        if elems == 0:
            return
        out = self._core2(port.buffer(elems), self._param)
        port.consume(elems)
        self.output(0).post(_as_np(out))

    # -- auto-fusion protocol: stateless f32 unary with baked param ----- #
    def fuse_ready(self) -> bool:
        return (self.dtype.is_float and self.dtype.bits == 32
                and not self.dtype.is_complex)

    def fuse_export(self, channels: int):
        p = jnp.float32(self._param)
        core2 = self._raw_core2

        def step(carry, x):
            return carry, core2(x, p)

        return (), step

    def fuse_import(self, carry) -> None:
        pass


@register_block("/comms/pow")
def pow_factory(dtype, exponent=0.0):
    dt = DType.parse(dtype)
    if dt.is_complex:
        raise ValueError("pow: real types only")
    blk = _ParamUnary(dt, ew.pow_fn(dt), exponent)
    blk.set_exponent = blk.set_param
    blk.exponent = lambda: blk._param[()]
    blk.setExponent = blk.set_exponent
    return blk


@register_block("/comms/sqrt")
def sqrt_factory(dtype):
    dt = DType.parse(dtype)
    return ElementwiseBlock(dt, ew.root_fn(dt, "sqrt"))


@register_block("/comms/cbrt")
def cbrt_factory(dtype):
    dt = DType.parse(dtype)
    return ElementwiseBlock(dt, ew.root_fn(dt, "cbrt"))


@register_block("/comms/nth_root")
def nth_root_factory(dtype, root=1.0):
    dt = DType.parse(dtype)
    blk = _ParamUnary(dt, ew.root_fn(dt, "nth"), root)
    blk.set_root = blk.set_param
    blk.root = lambda: blk._param[()]
    blk.setRoot = blk.set_root
    return blk


# --------------------------------------------------------------------- #
# Log / Exp families (reference: math/Log.cpp, math/Exp.cpp)
# --------------------------------------------------------------------- #
def _simple_unary_factory(name):
    def factory(dtype):
        dt = DType.parse(dtype)
        if dt.is_complex:
            raise ValueError(f"{name}: real types only")
        return ElementwiseBlock(dt, ew.unary_fn(dt, name))

    return factory


for _name, _paths in [
    ("log", ("/comms/log",)),
    ("log2", ("/comms/log2",)),
    ("log10", ("/comms/log10",)),
    ("log1p", ("/comms/log1p",)),
    ("exp", ("/comms/exp",)),
    ("exp2", ("/comms/exp2",)),
    ("exp10", ("/comms/exp10",)),
    ("expm1", ("/comms/expm1",)),
]:
    register_block(*_paths)(_simple_unary_factory(_name))


@register_block("/comms/logN")
def logn_factory(dtype, base=10.0):
    dt = DType.parse(dtype)

    class _LogN(ElementwiseBlock):
        def set_base(self, b):
            if b <= 1:
                raise ValueError("logN base must be > 1")
            self._raw_core = ew.logn_fn(dt, float(b))
            self._core = self.jit(self._raw_core)
            self._base = float(b)
            self._bump_fuse_epoch()

        def base(self):
            return self._base

    blk = _LogN(dt, ew.logn_fn(dt, float(base)))
    blk._base = float(base)
    return blk


@register_block("/comms/expN")
def expn_factory(dtype, base=10.0):
    dt = DType.parse(dtype)

    class _ExpN(ElementwiseBlock):
        def set_base(self, b):
            if b <= 1:
                raise ValueError("expN base must be > 1")
            self._raw_core = ew.expn_fn(dt, float(b))
            self._core = self.jit(self._raw_core)
            self._base = float(b)
            self._bump_fuse_epoch()

        def base(self):
            return self._base

    blk = _ExpN(dt, ew.expn_fn(dt, float(base)))
    blk._base = float(base)
    return blk


# --------------------------------------------------------------------- #
# ModF — two output ports (reference: math/ModF.cpp:17-40)
# --------------------------------------------------------------------- #
@register_block("/comms/modf")
def modf_factory(dtype):
    dt = DType.parse(dtype)
    if not dt.is_float or dt.is_complex:
        raise ValueError("modf: float types only")
    return ModF(dt)


class ModF(Block):
    def __init__(self, dtype):
        super().__init__()
        self.dtype = DType.parse(dtype)
        self.setup_input(0, self.dtype)
        self.setup_output("int", self.dtype)
        self.setup_output("frac", self.dtype)
        self._core = self.jit(ew.modf_fn(self.dtype))

    def work(self):
        port = self.input(0)
        elems = port.elements()
        if elems == 0:
            return
        integral, frac = self._core(port.buffer(elems))
        port.consume(elems)
        self.output("int").post(_as_np(integral))
        self.output("frac").post(_as_np(frac))

    # -- auto-fusion: 2-output TAIL (int plane, frac plane) ------------- #
    def fuse_ready(self) -> bool:
        return (self.dtype.is_float and self.dtype.bits == 32
                and not self.dtype.is_complex)

    def fuse_label_adjust(self, lb):
        return lb

    def fuse_export(self, channels: int):
        def step(carry, x):
            i = jnp.trunc(x)
            return carry, (i, x - i)

        return (), step

    def fuse_import(self, carry) -> None:
        pass
