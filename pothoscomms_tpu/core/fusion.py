"""Automatic device-core fusion for the streaming executor.

The reference framework's scheduler IS the delivery vehicle for block
performance: every topology gets the SIMD hot loops without opting in
(SURVEY.md §1 L0; math/Arithmetic.cpp:204-231 runs inside the
framework). The equivalent here: at ``Topology.commit()`` the
executor detects maximal linear runs of blocks that expose a fused
device core, and — once sustained load appears on the run's head edge —
executes the whole run as ONE jitted XLA program per work quantum,
with stream data staying device-resident between quanta.

Design:

- **Fusion is a turbo, not a mode.** Blocks stream normally (host
  numpy, full label/packet semantics) until the head queue crosses
  ``Topology.fuse_threshold`` elements; the segment then *engages*:
  each member exports its streaming state into its device-core carry
  (``fuse_export``) and the composed chain runs jitted. Any label or
  message arriving at the head, any member reconfiguration
  (``_fuse_epoch`` bump), or the stream draining *disengages* the
  segment: carries are imported back into streaming state
  (``fuse_import``) and the members resume the exact reference
  semantics. Export/import are lossless inverses, so engage/disengage
  can alternate freely mid-stream.
- **Peephole**: an adjacent FIR -> forward-FFT pair compiles to the
  combined FIR*DFT operator (parallel/chain.py) instead of two
  separate cores.
- **Device-resident edges**: a segment posts its output as a
  :class:`DeviceChunk` — a planar-f32 device array wrapped with the
  port dtype. Downstream fused segments consume it without a host
  round-trip; legacy blocks materialize it transparently via
  ``__array__``.

Block protocol (implemented by fusable blocks):

- ``fuse_ready() -> bool`` — non-consuming eligibility check (dtype is
  32-bit float, config supported, retained state present).
- ``fuse_export(channels) -> (carry, step)`` — build the device core
  and its carry from CURRENT streaming state, consuming any port-held
  state (e.g. the FIR's K-1 queued history samples).
- ``fuse_import(carry) -> None`` — restore streaming state from the
  carry (inverse of export).
- ``fuse_kind`` — optional class tag ("fir", "fft") for the peephole.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import numpy as np

from pothoscomms_tpu.core.dtypes import DType

# Engage only pays off under sustained load; pulls below this floor are
# left for the streaming path (end-of-stream drain disengages). The
# effective floor is min(MIN_PULL, topology.fuse_threshold) so tests
# with a lowered threshold still engage on small data.
MIN_PULL = 1 << 16
# Elements per fused step cap. Pull sizes step down from here in
# FACTORS OF 4 (not 2) to bound the number of distinct compiled shapes.
# At 32 Mi the FIR+FFT pair reshapes to [256, 131072], the program shape
# of bench.py's hand-compiled chain. The value was tuned for a device
# link with a large fixed cost per call; it awaits re-derivation from
# measured H100 dispatch cost and memory (ROADMAP §1.3).
MAX_QUANTUM = 1 << 25
# Row length the FIR(+FFT) pair reshapes big pulls into: a [R, ROW]
# batch instead of one enormous single-row call (FIR history stitches
# across rows). Awaits re-derivation with MAX_QUANTUM (ROADMAP §1.3).
PAIR_ROW = 1 << 17


@functools.lru_cache(maxsize=512)
def _slice_fn(start: int, stop: int):
    """Jitted contiguous row-slice: one cached dispatch per
    (start, stop); jax.jit handles per-shape caching."""
    import jax

    return jax.jit(lambda a: jax.lax.slice_in_dim(a, start, stop, axis=0))


@functools.lru_cache(maxsize=64)
def _concat_fn(n: int):
    """Jitted n-way row-concat, cached per part count."""
    import jax
    import jax.numpy as jnp

    return jax.jit(lambda *parts: jnp.concatenate(parts, axis=0))


class DeviceChunk:
    """A device-resident slice of stream data flowing between blocks.

    ``planar`` is a jax array: [n, 2] float32 for complex streams
    (re/im planes), [n] float32 for real streams. Legacy host blocks
    receive the dtype-faithful numpy view via ``__array__``; fused
    segments consume ``planar`` directly with zero copies.
    """

    __slots__ = ("planar", "dtype")

    def __init__(self, planar, dtype: DType):
        self.planar = planar
        self.dtype = DType.parse(dtype)

    @property
    def shape(self):
        return (int(self.planar.shape[0]),) + self.dtype.storage_shape_suffix

    def __len__(self):
        return int(self.planar.shape[0])

    def __getitem__(self, sl):
        # contiguous row slices go through a jit-cached kernel
        n = int(self.planar.shape[0])
        start, stop, step = sl.indices(n)
        if step != 1:
            return DeviceChunk(self.planar[sl], self.dtype)
        if start == 0 and stop == n:
            return self
        return DeviceChunk(_slice_fn(start, stop)(self.planar), self.dtype)

    def __array__(self, dtype=None, copy=None):
        p = np.asarray(self.planar)
        if self.dtype.is_complex_int:
            # planar [n, 2] integer-valued f32 -> [n, 2] storage ints
            out = np.rint(p).astype(self.dtype.np)
        elif self.dtype.is_complex:
            out = (p[..., 0] + 1j * p[..., 1]).astype(self.dtype.np)
        elif self.dtype.is_integer:
            # device cores produce exact integer values, but round
            # defensively: a f32 3.9999997 must not truncate to 3
            out = np.rint(p).astype(self.dtype.np)
        else:
            out = p.astype(self.dtype.np)
        if dtype is not None:
            out = out.astype(dtype)
        return out


@functools.lru_cache(maxsize=4)
def _cast_f32_fn():
    import jax
    import jax.numpy as jnp

    return jax.jit(lambda a: a.astype(jnp.float32))


def to_planar_jax(part, dtype: DType):
    """Any queued part (numpy or DeviceChunk) -> planar f32 jax array.
    Integer streams (uint8 bits/symbols, int16 fixed point) ride as
    integer-VALUED f32 planes (every value < 2^24 is exact in f32; the
    stream layout is open, ROADMAP §3.4). Narrow ints upload in their
    NATIVE width and widen on device, so the host link moves 1-2 bytes
    per element."""
    import jax.numpy as jnp

    if isinstance(part, DeviceChunk):
        return part.planar
    arr = np.asarray(part)
    if dtype.is_integer and arr.dtype.itemsize <= 2:
        return _cast_f32_fn()(jnp.asarray(arr))
    if dtype.is_complex_int:
        return jnp.asarray(arr.astype(np.float32))  # already [n, 2]
    if dtype.is_complex:
        return jnp.asarray(
            np.stack([arr.real, arr.imag], -1).astype(np.float32))
    return jnp.asarray(arr.astype(np.float32))


def _is_fusable(blk) -> bool:
    return (hasattr(blk, "fuse_export") and hasattr(blk, "fuse_ready")
            and len(blk.inputs) == 1 and len(blk.outputs) == 1)


def _is_head_fusable(blk) -> bool:
    """A run HEAD may have several input ports (fan-in: N-ary
    Arithmetic, Comparator, CombineComplex — reference
    math/Arithmetic.cpp:204-231): the segment pulls an aligned quantum
    from every head port. Interior blocks stay 1-in/1-out."""
    return (hasattr(blk, "fuse_export") and hasattr(blk, "fuse_ready")
            and len(blk.inputs) >= 1 and len(blk.outputs) == 1)


def _is_source_fusable(blk) -> bool:
    """Unbounded source with a device generation core: may HEAD a run
    (no input port — the segment is driven by the source quota and the
    whole chain runs device-resident with zero H2D per quantum)."""
    return (hasattr(blk, "fuse_source_export")
            and hasattr(blk, "fuse_source_ready")
            and not blk.inputs and len(blk.outputs) == 1)


def detect_segments(blocks, topology) -> List["FusedSegment"]:
    """Maximal linear runs (length >= 2) of fusable blocks where each
    interior edge is exactly one output port feeding exactly one input
    port. A run may be HEADED by a fusable source (quota-driven). A
    frames-out block (FFT) terminates its run. Fan-OUT at the run tail
    is fine — the tail posts its DeviceChunk to every consumer."""
    used = set()
    segments = []
    # blocks that are fusion-run interiors must not be fan-in targets
    feeders = {}
    for blk in blocks:
        for out in blk.outputs.values():
            for port in out.downstream:
                feeders[id(port)] = feeders.get(id(port), 0) + 1
    for blk in blocks:
        if id(blk) in used or not (_is_head_fusable(blk)
                                   or _is_source_fusable(blk)):
            continue
        run = [blk]
        cur = blk
        while getattr(cur, "fuse_kind", None) != "fft":
            outs = list(cur.outputs.values())
            ds = outs[0].downstream
            if len(ds) != 1:
                break
            nxt = ds[0].block
            if (id(nxt) in used or nxt is blk or len(nxt.inputs) != 1
                    or feeders.get(
                        id(next(iter(nxt.inputs.values()))), 0) != 1):
                break
            if _is_fusable(nxt):
                run.append(nxt)
                used.add(id(nxt))
                cur = nxt
                continue
            if (hasattr(nxt, "fuse_export") and hasattr(nxt, "fuse_ready")
                    and len(nxt.outputs) > 1):
                # multi-output block (SplitComplex): joins only as the
                # TERMINAL tail — the segment posts one DeviceChunk per
                # output port
                run.append(nxt)
                used.add(id(nxt))
            break
        if len(run) >= 2:
            used.update(id(b) for b in run)
            seg = FusedSegment(run, topology)
            # stashing assumes nothing posts into the head port later
            # in the round than the head's own schedule slot (true for
            # forward-only graphs; feedback edges disable it). A
            # source-headed segment has no head port (no labels either).
            if seg.head is not None:
                order = {id(b): i for i, b in enumerate(blocks)}
                head_idx = order[id(run[0])]
                seg.stash_safe = all(
                    order.get(id(b2), head_idx) < head_idx
                    for b2 in blocks
                    for out in b2.outputs.values()
                    for port in out.downstream
                    if port in seg.heads
                )
            segments.append(seg)
    return segments


def _source_chain_step(src_step, cores, t: int):
    """Compose a source generation step with downstream cores into one
    jitted program for a STATIC quantum of ``t`` elements (the source
    has no input array to carry the shape, so t is baked per trace;
    quanta come from the base-4 bucket ladder, bounding trace count)."""
    import jax

    @jax.jit
    def step(carries, params):
        c0, x = src_step(carries[0], t, *params[0])
        new = [c0]
        for core, c, p in zip(cores, carries[1:], params[1:]):
            c2, x = core(c, x, *p)
            new.append(c2)

        def fin(v):
            v = v[0]
            if v.ndim == 3:  # FFT frames [nw, nbins, 2] -> stream
                v = v.reshape(-1, 2)
            return v

        if isinstance(x, tuple):  # multi-output tail (SplitComplex)
            return tuple(fin(v) for v in x), tuple(new)
        return fin(x), tuple(new)

    return step


def _chain_step(cores):
    """Compose per-core steps into one jitted program. Each core has
    signature ``core(carry, x, *params) -> (carry', y)``; params are
    passed as jit ARGUMENTS (operator matrices are uploaded once at
    export, not baked into the program as constants).

    ``x`` may be a TUPLE of stream arrays for a fan-in head (N-ary
    Arithmetic etc.) — the head core then receives the tuple of
    [1, T(, 2)] planars and reduces it to one stream.

    The output is flattened to stream layout ([T, 2] planar / [T] real)
    INSIDE the program, so no eager array op touches the result."""
    import jax

    @jax.jit
    def step(x, carries, params):
        # stream [T(, 2)] -> [C=1, T(, 2)] inside jit
        if isinstance(x, (tuple, list)):
            x = tuple(v[None] for v in x)
            if len(x) == 1:
                x = x[0]
        else:
            x = x[None]
        new = []
        for core, c, p in zip(cores, carries, params):
            c2, x = core(c, x, *p)
            new.append(c2)

        def fin(v):
            v = v[0]  # drop the channel axis
            if v.ndim == 3:  # FFT frames [nw, nbins, 2] -> stream
                v = v.reshape(-1, 2)
            return v

        # a multi-output TAIL (SplitComplex) returns a tuple: one
        # stream per tail port
        if isinstance(x, tuple):
            return tuple(fin(v) for v in x), tuple(new)
        return fin(x), tuple(new)

    return step


def _carry_sig(carries):
    leaves = []

    def walk(c):
        if isinstance(c, (tuple, list)):
            for e in c:
                walk(e)
        elif c is None:
            leaves.append(None)
        else:
            leaves.append(tuple(getattr(c, "shape", ())))

    walk(carries)
    return tuple(leaves)


class FusedSegment:
    """A linear run of fusable blocks executed as one jitted program
    while engaged (see module docstring)."""

    def __init__(self, blocks, topology):
        self.blocks = blocks
        self.topology = topology
        # source-headed segments have no head input port: they are
        # driven by the source block's production quota instead
        self.source = blocks[0] if not blocks[0].inputs else None
        self.heads = ([] if self.source
                      else list(blocks[0].inputs.values()))
        self.head = self.heads[0] if len(self.heads) == 1 else None
        self.tail_outs = list(blocks[-1].outputs.values())
        self.tail_out = self.tail_outs[0]
        self.head_dtype = (blocks[0].output(0).dtype if self.source
                           else self.heads[0].dtype)
        self.tail_dtypes = [o.dtype for o in self.tail_outs]
        self.tail_dtype = self.tail_out.dtype
        # Label-transparent runs: every member's label propagation is a
        # pure index rescale and its compute ignores labels — the fused
        # path may then process THROUGH labels, re-emitting them
        # index-adjusted on the tail instead of disengaging (the
        # framed-digital-link unlock; single-head runs only).
        self.label_transparent = (
            self.head is not None
            and all(callable(getattr(b, "fuse_label_adjust", None))
                    for b in blocks))
        # source-headed: per-quantum-shape compiled steps + the source
        # step/params exported at engage
        self._source_step = None
        self._source_params = None
        self._tail_cores = None
        self._tail_params = None
        self.engaged = False
        self._cold_extra = 0
        self.step = None
        self.carries = None
        self.params = None
        self._imports = None  # aligned with carries: fn(carry) restores
        self._epochs = None
        self._refresh_geometry()
        # compiled-step cache across engage cycles: jit instances keyed
        # by (member epochs, carry shapes) so a disengage/re-engage
        # (labels, drain) reuses XLA's compile cache instead of paying
        # a fresh trace+compile per pull shape every time
        self._step_cache: dict = {}
        # post-label backlog withheld from the streaming drain for the
        # remainder of the current round (returned by the topology at
        # round end so the next round re-engages on it)
        self.stash: Optional[list] = None
        # True when every block feeding the head port is scheduled
        # before this segment's head in the round order — the
        # precondition for the stash being newest data in the port
        # (set by detect_segments)
        self.stash_safe = False
        # a cold FIR->FFT adjacency engaged as singles; after the first
        # quantum warms the history carry, cycle the engagement so the
        # pair peephole compiles the combined operator (see try_engage)
        self._pair_pending = False
        # head-unit over-pull of the FIRST quantum after a cold-start
        # engage (source-headed; see try_engage)
        self._cold_extra = 0
        # observability: engagements, elements pulled fused, the
        # largest quantum pulled, and FIR->FFT pairs in the last engage
        self.engage_count = 0
        self.fused_elements = 0
        self.max_quantum = 0
        self.pairs = 0

    # ------------------------------------------------------------------ #
    def _refresh_geometry(self) -> None:
        """Pull granule and output/input sample ratio. Recomputed at
        engage: FFT bins are fixed, but a rational FIR's M/L (and with
        them its block granule) can change with reconfiguration.

        A block's granule applies at ITS OWN input; with rate-changing
        members upstream the head-unit requirement is scaled through
        the cumulative ratio r = p/s reaching that input: a head pull
        of q reaches the block as q*p/s elements, so q must be a
        multiple of g_b*s / gcd(g_b*s, p) (which also enforces
        integrality of every interior edge size via g_b = 1)."""
        import math
        from fractions import Fraction

        g = 1
        ratio = Fraction(1)
        for b in self.blocks:
            gb = 1
            if getattr(b, "fuse_kind", None) == "fft":
                gb = b.num_bins
            fg = getattr(b, "fuse_granule", None)
            if callable(fg):
                gb = math.lcm(gb, fg())
            p, s = ratio.numerator, ratio.denominator
            need = (gb * s) // math.gcd(gb * s, p)
            g = math.lcm(g, need)
            fr = getattr(b, "fuse_ratio", None)
            if callable(fr):
                o, i = fr()
                ratio *= Fraction(o, i)
        self.granule = g
        self.out_per_in = ratio

    def _free_to_input_units(self, free: int) -> int:
        """Downstream free space (output units) -> input-unit budget."""
        r = self.out_per_in
        return int(free * r.denominator // r.numerator)

    def backlog(self) -> int:
        """Elements available to fuse: head-port queue depth (the
        aligned minimum over fan-in heads), or the source quota for a
        source-headed segment."""
        if self.source is not None:
            return self.source._source_quota
        return min(p.elements() for p in self.heads)

    def _epoch_sig(self):
        return tuple(b._fuse_epoch for b in self.blocks)

    def _interior_clean(self) -> bool:
        for b in self.blocks[1:]:
            p = b.input(0)
            if p.labels or p._messages:
                return False
        return True

    def _head_label_limit(self) -> Optional[int]:
        """Index of the first label queued at any head (None if none).
        For label-OPAQUE segments the fused path may process UP TO a
        label; the labeled region itself runs streaming (sample-accurate
        label semantics, e.g. Scale's factor-by-label,
        math/Scale.cpp:104-122). Label-TRANSPARENT segments ignore this
        and carry labels through (see work())."""
        idxs = [lb.index for p in self.heads for lb in p.labels]
        return min(idxs) if idxs else None

    def _head_retained(self) -> int:
        b = self.blocks[0]
        ret = b.fuse_retained() if hasattr(b, "fuse_retained") else 0
        return ret or 0

    def try_engage(self) -> bool:
        if self.engaged or not self._interior_clean():
            return False
        if any(p._messages for p in self.heads):
            return False
        self._refresh_geometry()
        # engaging must yield at least one label-free pull quantum AFTER
        # the head block's retained state is exported off the queue —
        # otherwise the segment would engage, pull nothing, and
        # disengage every round while starving the members. (A
        # label-transparent segment carries labels through instead, so
        # they don't bound the quantum.)
        if self.source is not None:
            avail = self.source._source_quota
        else:
            head_ret = self._head_retained()
            avail = min(p.elements() for p in self.heads) - head_ret
            if not self.label_transparent:
                limit = self._head_label_limit()
                if limit is not None:
                    avail = min(avail, limit - head_ret)
        if self._bucket(avail) == 0:
            return False
        if not all((b.fuse_source_ready() if b is self.source
                    else b.fuse_ready()) for b in self.blocks):
            return False
        # Interior ports must hold EXACTLY their block's steady-state
        # retention (FIR: K-1 history; FFT: any sub-frame leftover,
        # absorbed by export; others: nothing). Residual unprocessed
        # backlog there would be bypassed by the fused path and replay
        # out of order on disengage — stream until it drains instead.
        #
        # COLD START (source-headed segments only): a FIR with an EMPTY
        # port engages before any streaming round — its carry starts
        # zero-length, the FIRST quantum over-pulls by K-1 (in head
        # units through the cumulative rate ratio) and the core drops
        # the K-1 zero-history outputs in-program, so every later
        # quantum stays ladder- and frame-aligned.
        from fractions import Fraction

        cold_extra = Fraction(0)
        ratio = Fraction(1)
        for b in self.blocks[1:] if self.source is not None else \
                self.blocks:
            retained = (b.fuse_retained()
                        if hasattr(b, "fuse_retained") else 0)
            port0 = (next(iter(b.inputs.values()))
                     if b.inputs and b is not self.blocks[0] else None)
            if (port0 is not None and retained is not None
                    and port0.elements() != retained):
                if (self.source is not None and port0.elements() == 0
                        and cold_extra == 0
                        and getattr(b, "fuse_cold_start",
                                    lambda: False)()):
                    # at most ONE cold member: its K-1 head-unit
                    # over-pull leaves a ladder-aligned body; a second
                    # cold FIR downstream would see a misaligned stream
                    cold_extra += retained / ratio
                else:
                    return False
            fr = getattr(b, "fuse_ratio", None)
            if callable(fr):
                o, i = fr()
                ratio *= Fraction(o, i)
        if cold_extra.denominator != 1:
            return False  # K-1 not expressible in head units: warm up
        self._cold_extra = int(cold_extra)
        # plan the unit list (pair peephole) WITHOUT side effects, then
        # export carries; the compiled step + device params are cached
        # by (epochs, carry shapes) so a re-engage neither re-traces nor
        # re-uploads the pair's operator matrices
        stream_blocks = (self.blocks[1:] if self.source is not None
                         else self.blocks)
        units: List = []  # ("pair", fir, fft) | ("single", b)
        self._pair_pending = False
        i = 0
        while i < len(stream_blocks):
            b = stream_blocks[i]
            nxt = stream_blocks[i + 1] if i + 1 < len(stream_blocks) else None
            if (nxt is not None and getattr(b, "fuse_kind", None) == "fir"
                    and getattr(nxt, "fuse_kind", None) == "fft"):
                if self._pair_eligible(b, nxt):
                    units.append(("pair", b, nxt))
                    i += 2
                    continue
                if (getattr(b, "fuse_cold_start", lambda: False)()
                        and self._pair_eligible(b, nxt, cold_ok=True)):
                    # a COLD FIR can't join the combined operator (its
                    # history export needs K-1 queued samples); engage
                    # with single cores now and cycle to the pair after
                    # the first quantum warms the carry (see work())
                    self._pair_pending = True
            units.append(("single", b))
            i += 1
        self.pairs = sum(u[0] == "pair" for u in units)
        carries: List = []
        imports: List = []
        fresh_cores: List = []
        if self.source is not None:
            carry, src_step, src_params = self.source.fuse_source_export(1)
            carries.append(carry)
            imports.append(
                lambda c, s=self.source: s.fuse_source_import(c))
            self._source_step = src_step
            self._source_params = src_params
        for u in units:
            if u[0] == "pair":
                _, fir, fft = u
                carry, _ = fir.fuse_export(1)
                fft.fuse_export(1)  # stateless here (leftover == 0)
                carries.append(carry)
                imports.append(lambda c, fir=fir: fir.fuse_import(c))
                fresh_cores.append(None)  # built on cache miss
            else:
                b = u[1]
                exp = b.fuse_export(1)
                carry, step = exp[0], exp[1]
                # optional third element: device-resident operator
                # params (e.g. the scrambler's GF(2) block matrices),
                # passed as jit ARGUMENTS and uploaded once at export
                bparams = tuple(exp[2]) if len(exp) > 2 else ()
                carries.append(carry)
                imports.append(lambda c, b=b: b.fuse_import(c))
                fresh_cores.append((step, bparams))
        self.carries = tuple(carries)
        self._imports = imports
        self._epochs = self._epoch_sig()
        if self.source is not None:
            # per-quantum-shape jitted steps are built lazily in work()
            # (t is static per trace); cache the composed cores/params
            ckey = ("src-cores", self._epochs)
            cached = self._step_cache.get(ckey)
            if cached is None:
                cores: List = []
                params: List = []
                for u, core in zip(units, fresh_cores):
                    if u[0] == "pair":
                        step, p = self._build_pair_core(u[1], u[2])
                        cores.append(step)
                        params.append(p)
                    else:
                        step, bp = core
                        cores.append(step)
                        params.append(bp)
                cached = (cores, tuple(params))
                self._step_cache[ckey] = cached
            self._tail_cores, self._tail_params = cached
        else:
            key = (self._epochs, _carry_sig(self.carries))
            cached = self._step_cache.get(key)
            if cached is None:
                cores: List = []
                params: List = []
                for u, core in zip(units, fresh_cores):
                    if u[0] == "pair":
                        step, p = self._build_pair_core(u[1], u[2])
                        cores.append(step)
                        params.append(p)
                    else:
                        step, bp = core
                        cores.append(step)
                        params.append(bp)
                cached = (_chain_step(cores), tuple(params))
                if len(self._step_cache) > 16:
                    self._step_cache.clear()
                self._step_cache[key] = cached
            self.step, self.params = cached
        self.engaged = True
        self.engage_count += 1
        return True

    @staticmethod
    def _pair_eligible(fir, fft, cold_ok: bool = False) -> bool:
        """Combined FIR*DFT operator preconditions (no side effects):
        1:1 rate, complex stream, 1 < K <= min(128, nbins)+1, forward
        FFT, no mid-frame leftover phase, K-1 history present (a cold
        FIR engages with single cores first; ``cold_ok`` checks
        everything EXCEPT the history for the pending-pair cycle)."""
        if fir._M != 1 or fir._L != 1:
            return False
        if fft.inverse or not fir.dtype.is_complex:
            return False
        if fir.dtype.is_integer or fft.dtype.is_integer:
            return False  # int16 pairs need per-block Q-format rounding
        k = len(fir._taps)
        pp = min(128, fft.num_bins)
        if not (1 < k <= pp + 1):
            return False
        if not cold_ok and fir.input(0).elements() < k - 1:
            return False  # cold FIR: fuse_export cannot take history
        return fft.input(0).elements() == 0

    def _build_pair_core(self, fir, fft):
        """Adjacent FIR -> forward FFT as the combined FIR*DFT operator
        (parallel/chain.py). Big pulls are reshaped into [R, PAIR_ROW]
        rows with the FIR history stitched across rows (overlap-save),
        the batched program shape of bench.py's hand-compiled chain."""
        k = len(fir._taps)
        nbins = fft.num_bins
        pp = min(128, nbins)
        from pothoscomms_tpu.parallel.chain import (
            combined_fir_fft_operators, fir_fft_combined_step)
        import jax.numpy as jnp

        (g0r, g0i), (g1r, g1i) = combined_fir_fft_operators(
            fir._taps, nbins, pp)
        params = (g0r, g0i, g0r + g0i, g1r, g1i, g1r + g1i)

        def step(carry, x, g0r, g0i, g0s, g1r, g1i, g1s):
            t = x.shape[1]
            # r: power of two <= 256 that divides the window count, so
            # each row is a whole number of nbins-windows
            nw = t // nbins
            v2 = (nw & -nw).bit_length() - 1  # trailing zeros of nw
            r0 = min(256, max(1, t // PAIR_ROW))
            r = 1 << min(v2, r0.bit_length() - 1)
            row = t // r
            xr = x.reshape(r, row, 2)
            if r > 1 and k > 1:
                # row i's history = tail of row i-1 (overlap-save)
                tails = xr[:-1, row - (k - 1):, :]
                hists = jnp.concatenate([carry, tails], axis=0)
            else:
                hists = carry
            spec, _ = fir_fft_combined_step(
                xr, hists, g0r, g0i, g0s, g1r, g1i, g1s, nbins, k, pp)
            new_carry = xr[-1:, row - (k - 1):, :] if k > 1 \
                else xr[-1:, :0, :]
            return new_carry, spec.reshape(1, t // nbins, nbins, 2)

        return step, params

    def disengage(self) -> None:
        if not self.engaged:
            return
        for imp, carry in zip(self._imports, self.carries):
            imp(carry)
        self.engaged = False
        self._cold_extra = 0
        self.step = None
        self.carries = None
        self.params = None
        self._imports = None
        self._source_step = None
        self._source_params = None
        self._tail_cores = None
        self._tail_params = None

    # ------------------------------------------------------------------ #
    def _bucket(self, n: int) -> int:
        """Largest pull from the base-4 shape ladder g*4^k <= n, topped
        by MAX_QUANTUM itself (rounded down to the granule). Base 4
        (not 2) halves the count of distinct compiled shapes — each new
        shape compiles the whole fused program — at the price of at most
        3 pulls per ladder rung during a drain. Without the top rung a
        granule whose base-4 ladder skips the cap (1024: ..., 16 Mi,
        64 Mi) would never pull a full MAX_QUANTUM."""
        g = self.granule
        thresh = getattr(self.topology, "fuse_threshold", None) or MIN_PULL
        floor = max(g, min(MIN_PULL, thresh))
        if n < floor:
            return 0
        q = g
        while q * 4 <= min(n, MAX_QUANTUM):
            q *= 4
        top = MAX_QUANTUM - MAX_QUANTUM % g
        if q < top <= n:
            q = top
        return q if q >= floor else 0

    def _pull(self, port, n: int):
        """First n queued elements of ``port`` as one flat planar
        device array ([T(, 2)]; the channel axis is added inside the
        jitted step; the multi-part case concatenates through a
        jit-cached kernel)."""
        parts = port.take(n)
        planars = [to_planar_jax(p, port.dtype) for p in parts]
        if len(planars) == 1:
            return planars[0]
        return _concat_fn(len(planars))(*planars)

    def _collect_head_labels(self, q: int):
        """Remove and return head labels inside the pull quantum (label
        -transparent segments re-emit them adjusted on the tail).
        Removing them BEFORE take() keeps the port's consume accounting
        from auto-propagating them into the interior ports."""
        port = self.head
        taken = [lb for lb in port.labels if lb.index < q]
        if taken:
            port.labels = [lb for lb in port.labels if lb.index >= q]
            taken.sort(key=lambda lb: lb.index)
        return taken

    def work(self) -> None:
        if not self.engaged:
            return
        if self.source is not None:
            self._work_source()
            return
        if (any(p._messages for p in self.heads)
                or self._epoch_sig() != self._epochs):
            # messages demand the streaming path; reconfig demands new
            # cores — both via disengage (re-engage follows once the
            # queue is clean and over threshold again)
            self.disengage()
            return
        avail = min(p.elements() for p in self.heads)
        limit = None
        if not self.label_transparent:
            limit = self._head_label_limit()
            if limit is not None:
                # fused processing runs up to the label; the labeled
                # region streams with exact per-sample semantics
                avail = min(avail, limit)
        frees = [o.free_space() for o in self.tail_outs]
        free = (None if all(f is None for f in frees)
                else min(f for f in frees if f is not None))
        cap = avail if free is None else min(
            avail, max(self._free_to_input_units(free), 0))
        q = self._bucket(cap)
        if q == 0:
            # q can be 0 either because the LABEL bounds the pull (the
            # labeled region must stream — disengage) or purely from
            # downstream congestion (free_space exhausted — just retry
            # next round; disengaging would thrash engage/disengage and
            # push the whole backlog through the slow streaming path)
            if limit is not None and self._bucket(avail) == 0:
                # label within one quantum: the labeled region must
                # stream. Withhold the label-free backlog behind it so
                # the streaming drain stays bounded and the backlog
                # re-engages next round.
                port = self.head
                if self.stash_safe and port is not None:
                    last = max(lb.index + max(lb.width, 1)
                               for lb in port.labels)
                    if port.elements() > last:
                        self.stash = port.split_tail(last)
                self.disengage()
            return
        labels = (self._collect_head_labels(q)
                  if self.label_transparent else None)
        if len(self.heads) == 1:
            x = self._pull(self.heads[0], q)
        else:
            x = tuple(self._pull(p, q) for p in self.heads)
        y, self.carries = self.step(x, self.carries, self.params)
        out_labels = None
        if labels:
            # each member's index rescale applied in sequence — the
            # same per-block to_adjusted walk the streaming path takes
            out_labels = []
            for lb in labels:
                cur = lb
                for b in self.blocks:
                    cur = b.fuse_label_adjust(cur)
                out_labels.append(cur)
        ys = y if isinstance(y, tuple) else (y,)
        for out_port, dt, yy in zip(self.tail_outs, self.tail_dtypes, ys):
            out_port.post(DeviceChunk(yy, dt), out_labels)
        self.fused_elements += q
        self.max_quantum = max(self.max_quantum, q)
        if self._pair_pending:
            self._pair_pending = False
            self.disengage()
            self.try_engage()

    def _work_source(self) -> None:
        """One fused quantum of a source-headed segment: generate q
        elements ON DEVICE and run them through the chain in the same
        jitted program (no head port, no pull, no H2D)."""
        if self._epoch_sig() != self._epochs:
            self.disengage()
            return
        src = self.source
        avail = src._source_quota
        frees = [o.free_space() for o in self.tail_outs]
        free = (None if all(f is None for f in frees)
                else min(f for f in frees if f is not None))
        cap = avail if free is None else min(
            avail, max(self._free_to_input_units(free), 0))
        extra = self._cold_extra
        q = self._bucket(max(cap - extra, 0))
        if q == 0:
            # Source-headed segments are quota-driven: no more data is
            # coming, so the residual below the MIN_PULL floor drains
            # through SUB-FLOOR ladder rungs (granule*4^k) instead of
            # disengaging into the slow streaming path — this kills the
            # per-run disengage/re-engage churn while the rung shapes
            # stay on the same base-4 ladder (bounded compile count).
            if cap >= self.granule and free != 0:
                g = self.granule
                q = g
                while q * 4 <= cap:
                    q *= 4
            else:
                return
        q += extra  # cold-start: the first quantum covers K-1 history
        self._cold_extra = 0
        key = (self._epochs, _carry_sig(self.carries), q)
        step = self._step_cache.get(key)
        if step is None:
            step = _source_chain_step(self._source_step,
                                      self._tail_cores, q)
            if len(self._step_cache) > 16:
                self._step_cache.clear()
            self._step_cache[key] = step
        params = (self._source_params,) + tuple(self._tail_params)
        y, self.carries = step(self.carries, params)
        src._source_quota = max(0, src._source_quota - q)
        ys = y if isinstance(y, tuple) else (y,)
        for out_port, dt, yy in zip(self.tail_outs, self.tail_dtypes, ys):
            out_port.post(DeviceChunk(yy, dt))
        self.fused_elements += q
        self.max_quantum = max(self.max_quantum, q)
        if self._pair_pending:
            self._pair_pending = False
            self.disengage()
            self.try_engage()
