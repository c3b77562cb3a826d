"""Block protocol, typed ports, signals/slots, probes.

Equivalent of the ``Pothos::Block`` surface the reference blocks
are written against (reference: every block, e.g. math/Arithmetic.cpp
setupInput/setupOutput/registerCall/work/propagateLabels;
filter/FIRDesigner.cpp:189 registerSignal/emitSignal;
utility/SignalProbe.cpp:77-78 registerProbe).

Runtime model: single-threaded cooperative executor (see topology.py) calls
``work()`` whenever a block has sufficient input or pending messages. Blocks
read ``self.input(p).buffer()`` (a numpy view of queued samples), run their
**functional core** (a pure jitted JAX function — the device compute path), and
``consume``/``post`` results. Heavy chains bypass ports entirely via the
fused-chain compiler in :mod:`pothoscomms_tpu.parallel`.

Label index contract:
- labels presented on an input port are indexed relative to the front of
  the currently unconsumed buffer;
- labels posted on an output port are indexed relative to the first element
  produced by the current ``work()`` call.
"""

from __future__ import annotations

import collections
import re
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from pothoscomms_tpu.core.dtypes import DType
from pothoscomms_tpu.core.labels import Label
from pothoscomms_tpu.core.packet import Packet


_SCRATCH_MIN = 1 << 12  # floor capacity for the per-port scratch


# Default per-edge queue bound. The reference bounds every edge with a
# buffer manager whose slabs are sized in BYTES (SURVEY.md §1 "Buffer
# managers", fft/FFT.cpp:54-59); here a full input queue gates the
# upstream block's scheduling (see Topology._run_once), so a fast
# producer ahead of a slow consumer holds RSS flat instead of growing
# without limit. The bound is expressed in bytes and converted to an
# element capacity per port dtype — an element-count default would let a
# complex128 edge hold 16x the memory of an int8 edge. The floor must
# stay far above any block's reserve (max reserve in the catalog is a
# few thousand elements) so consumers can always eventually fire.
DEFAULT_EDGE_CAPACITY_BYTES = 4 << 20  # 4 MiB per edge
MIN_EDGE_CAPACITY = 1 << 14            # elements, >> max catalog reserve
DEFAULT_EDGE_CAPACITY = 1 << 20        # elements, for untyped ports
DEFAULT_MSG_CAPACITY = 1 << 14


def default_edge_capacity(dtype: Optional[DType]) -> int:
    """Per-dtype element capacity for the byte-sized default bound."""
    if dtype is None:
        return DEFAULT_EDGE_CAPACITY
    return max(DEFAULT_EDGE_CAPACITY_BYTES // max(dtype.itemsize, 1),
               MIN_EDGE_CAPACITY)


class InputPort:
    """Typed input queue.

    Data layout: a contiguous ``_scratch`` array holding the (already
    materialized) front of the queue as the live region
    ``[_s_start, _s_end)``, followed by ``_parts`` — parts pushed since
    the last ``buffer()`` call, kept un-copied (and un-materialized for
    DeviceChunks, which only ``take()`` should ever touch). ``buffer()``
    appends pending parts into the scratch tail with capacity doubling,
    so repeated buffer()/consume() cycles cost amortized O(1) copies per
    element instead of re-concatenating the whole queue per work call —
    the equivalent of the reference's circular input buffer managers
    (filter/FIRFilter.cpp:196-199). Reallocation always allocates fresh
    (never memmoves in place) so views handed out by earlier buffer()/
    take() calls stay valid.
    """

    def __init__(self, block: "Block", name: str, dtype: Optional[DType]):
        self.block = block
        self.name = name
        self.dtype = DType.parse(dtype) if dtype is not None else None
        self._parts: List[np.ndarray] = []
        self._scratch: Optional[np.ndarray] = None
        self._s_start = 0
        self._s_end = 0
        self.copied_elements = 0  # physical copy volume (observability)
        self._elements = 0
        self.labels: List[Label] = []
        self._messages: collections.deque = collections.deque()
        self.reserve = 0
        self.capacity: Optional[int] = default_edge_capacity(self.dtype)
        self.msg_capacity: Optional[int] = DEFAULT_MSG_CAPACITY
        self.total_consumed = 0
        self.total_popped = 0  # monotonic: messages popped (progress)
        self._consumed_this_work = 0
        # upstream output port, set on connect (for introspection)
        self.upstream: Optional["OutputPort"] = None

    # -- data ----------------------------------------------------------- #
    def elements(self) -> int:
        return self._elements

    def _scratch_live(self) -> int:
        return self._s_end - self._s_start

    def _reserve_tail(self, k: int, suffix, np_dtype) -> bool:
        """Ensure the scratch can absorb k more rows at its tail.
        Returns False when the pending data is layout-incompatible with
        the live region (caller falls back to a promoting concat)."""
        sc = self._scratch
        live = self._scratch_live()
        if sc is not None and live and (sc.dtype != np_dtype
                                        or sc.shape[1:] != tuple(suffix)):
            return False
        if (sc is None or sc.dtype != np_dtype
                or sc.shape[1:] != tuple(suffix)
                or self._s_end + k > sc.shape[0]):
            cap = _SCRATCH_MIN
            while cap < 2 * (live + k):
                cap *= 2
            new = np.empty((cap,) + tuple(suffix), np_dtype)
            if live:
                new[:live] = sc[self._s_start:self._s_end]
                self.copied_elements += live
            self._scratch = new
            self._s_start, self._s_end = 0, live
        return True

    def buffer(self, n: Optional[int] = None) -> np.ndarray:
        """A contiguous view of the first ``n`` (default: all) queued
        elements. Does not consume. This is the HOST path: pending
        DeviceChunk parts are materialized here (device consumers drain
        with take() instead)."""
        if self._parts:
            mats = [np.asarray(p) for p in self._parts]
            self._parts = []
            ok = True
            for a in mats:
                if not self._reserve_tail(int(a.shape[0]), a.shape[1:],
                                          a.dtype):
                    ok = False
                    break
                k = int(a.shape[0])
                self._scratch[self._s_end:self._s_end + k] = a
                self._s_end += k
                self.copied_elements += k
            if not ok:
                # layout-mismatched parts (pathological): one promoting
                # concat of everything, which becomes the new scratch
                live = self._scratch[self._s_start:self._s_end] \
                    if self._scratch_live() else None
                pieces = ([live] if live is not None else []) + mats
                combined = np.concatenate(pieces, axis=0) \
                    if len(pieces) > 1 else pieces[0]
                self.copied_elements += int(combined.shape[0])
                self._scratch = combined
                self._s_start, self._s_end = 0, int(combined.shape[0])
        if not self._scratch_live():
            shape = (0,) + (self.dtype.storage_shape_suffix
                            if self.dtype else ())
            base = self.dtype.np if self.dtype else np.float32
            return np.zeros(shape, dtype=base)
        buf = self._scratch[self._s_start:self._s_end]
        return buf if n is None else buf[:n]

    def consume(self, n: int) -> None:
        if n == 0:
            return
        assert n <= self._elements, f"consume({n}) > available {self._elements}"
        in_scratch = self._scratch_live()
        if n <= in_scratch:
            self._s_start += n
        else:
            need = n - in_scratch
            self._s_start = self._s_end
            while need:
                p = self._parts[0]
                ln = int(p.shape[0])
                if ln <= need:
                    self._parts.pop(0)
                    need -= ln
                else:
                    self._parts[0] = p[need:]
                    need = 0
        self._elements -= n
        self._account_consume(n)

    def _account_consume(self, n: int) -> None:
        self.total_consumed += n
        self._consumed_this_work += n
        # split labels: consumed ones go to propagation, rest re-base
        consumed, kept = [], []
        for lb in self.labels:
            (consumed if lb.index < n else kept).append(lb)
        self.labels = [lb.shifted(-n) for lb in kept]
        if consumed:
            self.block._propagate(self, consumed)

    def take(self, n: int) -> List:
        """Consume and return the first ``n`` elements as the list of
        queued parts covering them, WITHOUT concatenating — so
        device-resident parts (core/fusion.DeviceChunk) are never
        materialized to host. Used by the fused-segment executor."""
        assert n <= self._elements, f"take({n}) > available {self._elements}"
        out: List = []
        need = n
        in_scratch = self._scratch_live()
        if in_scratch and need:
            k = min(in_scratch, need)
            out.append(self._scratch[self._s_start:self._s_start + k])
            self._s_start += k
            need -= k
        while need:
            p = self._parts[0]
            ln = int(p.shape[0])
            if ln <= need:
                out.append(self._parts.pop(0))
                need -= ln
            else:
                out.append(p[:need])
                self._parts[0] = p[need:]
                need = 0
        self._elements -= n
        self._account_consume(n)
        return out

    def split_tail(self, keep: int) -> List:
        """Remove and return the queued parts BEYOND the first ``keep``
        elements (no counter changes — an internal re-queue used by the
        fused segment to bound a streaming pass to a labeled region).
        All labels must lie within ``keep``."""
        assert keep <= self._elements
        assert all(lb.index < keep for lb in self.labels)
        out: List = []
        excess = self._elements - keep
        while excess and self._parts:
            p = self._parts[-1]
            ln = int(p.shape[0])
            if ln <= excess:
                out.insert(0, self._parts.pop())
                excess -= ln
            else:
                self._parts[-1] = p[: ln - excess]
                out.insert(0, p[ln - excess:])
                excess = 0
        if excess:
            # tail reaches into the scratch live region: COPY it out —
            # future appends write past the shortened end and would
            # clobber a view
            cut = self._s_end - excess
            out.insert(0, self._scratch[cut:self._s_end].copy())
            self.copied_elements += excess
            self._s_end = cut
        self._elements = keep
        return out

    def push_front_buffer(self, arr) -> None:
        """Re-queue elements at the FRONT of the queue (state restore on
        fused-segment disengage: a block's retained history re-enters
        its port ahead of unprocessed data). Labels shift accordingly;
        consumption counters are not rewound."""
        n = int(arr.shape[0])
        if n == 0:
            return
        live = self._scratch_live()
        if live:
            # demote the scratch live region to a pending part behind
            # the restored history (fresh scratch on next buffer())
            self._parts.insert(0, self._scratch[self._s_start:self._s_end])
            self._scratch = None
            self._s_start = self._s_end = 0
        self._parts.insert(0, arr)
        self._elements += n
        self.labels = [lb.shifted(n) for lb in self.labels]

    def remove_label(self, label: Label) -> None:
        self.labels.remove(label)

    def set_reserve(self, n: int) -> None:
        self.reserve = n

    def set_capacity(self, elements: Optional[int],
                     messages: Optional[int] = None) -> None:
        """Bound this edge's queue (None = unbounded). A producer whose
        downstream port is at/over capacity is not scheduled until the
        consumer drains it — the backpressure equivalent of the
        reference's bounded buffer managers."""
        self.capacity = None if elements is None else int(elements)
        if messages is not None:
            self.msg_capacity = int(messages)

    def congested(self) -> bool:
        if self.capacity is not None and self._elements >= self.capacity:
            return True
        return (self.msg_capacity is not None
                and len(self._messages) >= self.msg_capacity)

    # -- messages ------------------------------------------------------- #
    def has_message(self) -> bool:
        return len(self._messages) > 0

    def pop_message(self) -> Any:
        self.total_popped += 1
        return self._messages.popleft()

    def push_message(self, msg: Any) -> None:
        self._messages.append(msg)

    # -- feeding (called by upstream/executor) --------------------------- #
    def push_buffer(self, arr, labels: Optional[List[Label]] = None):
        if type(arr).__name__ != "DeviceChunk" and not isinstance(
                arr, np.ndarray):
            arr = np.asarray(arr)
        if labels:
            off = self._elements
            self.labels.extend(lb.shifted(off) for lb in labels)
        if arr.shape[0]:
            self._parts.append(arr)
            self._elements += int(arr.shape[0])

    def push_label(self, label: Label) -> None:
        """Label indexed relative to the end of currently queued data."""
        self.labels.append(label.shifted(self._elements))


class OutputPort:
    def __init__(self, block: "Block", name: str, dtype: Optional[DType]):
        self.block = block
        self.name = name
        self.dtype = DType.parse(dtype) if dtype is not None else None
        self.downstream: List[InputPort] = []
        self.total_produced = 0
        self._produced_this_work = 0

    def connect(self, port: InputPort) -> None:
        self.downstream.append(port)
        port.upstream = self

    # -- posting -------------------------------------------------------- #
    def post(self, arr, labels: Optional[List[Label]] = None) -> None:
        """Produce ``arr`` with labels indexed relative to arr start.
        ``arr`` may be a core/fusion.DeviceChunk — device-resident data
        flows downstream without a host round-trip."""
        if type(arr).__name__ != "DeviceChunk" and not isinstance(
                arr, np.ndarray):
            arr = np.asarray(arr)
        n = int(arr.shape[0])
        for port in self.downstream:
            port.push_buffer(arr, labels)
        self.total_produced += n
        self._produced_this_work += n

    def post_label(self, label: Label) -> None:
        """Label indexed relative to the first element produced by the
        current work() call."""
        adj = label.shifted(-self._produced_this_work)
        for port in self.downstream:
            port.push_label(adj)

    def post_message(self, msg: Any) -> None:
        for port in self.downstream:
            port.push_message(msg)

    def free_space(self) -> Optional[int]:
        """Elements the most congested downstream queue can still accept
        (None = unbounded). Volume-aware blocks clamp their work size to
        this so a slow consumer bounds the edge queue tightly."""
        space: Optional[int] = None
        for port in self.downstream:
            if port.capacity is None:
                continue
            s = max(port.capacity - port._elements, 0)
            space = s if space is None else min(space, s)
        return space


class WorkInfo:
    def __init__(self, block: "Block"):
        ins = [p.elements() for p in block.inputs.values()]
        outs: List[int] = []
        self.min_in_elements = min(ins) if ins else 0
        self.min_elements = self.min_in_elements
        self.min_all_elements = self.min_in_elements


_CAMEL_RE = re.compile(r"(?<!^)(?=[A-Z])")


def _snake(name: str) -> str:
    return _CAMEL_RE.sub("_", name).lower()


class Block:
    """Base class for all processing blocks."""

    def __init__(self, name: Optional[str] = None):
        self.name = name or type(self).__name__
        self.inputs: Dict[str, InputPort] = {}
        self.outputs: Dict[str, OutputPort] = {}
        self._signals: Dict[str, List] = {}  # name -> [(block, slot_name)]
        self._probes: Dict[str, str] = {}
        self._active = False
        self._topology = None
        self._emit_queue = None  # set by Topology.commit to defer signals
        # observability counters (core/introspect.query_stats)
        self._work_calls = 0
        self._work_time = 0.0
        # True for blocks that generate data forever (waveform/noise
        # sources); the executor meters these via a production quota.
        self.unbounded_source = False
        self._source_quota = 0
        # bumped by setters that change fused-core behavior; the fused
        # segment compares epochs each quantum and rebuilds on change
        self._fuse_epoch = 0

    def _bump_fuse_epoch(self) -> None:
        self._fuse_epoch += 1

    # -- port setup (reference: setupInput/setupOutput) ------------------ #
    def setup_input(self, name, dtype=None) -> InputPort:
        name = str(name)
        port = InputPort(self, name, dtype)
        self.inputs[name] = port
        return port

    def setup_output(self, name, dtype=None) -> OutputPort:
        name = str(name)
        port = OutputPort(self, name, dtype)
        self.outputs[name] = port
        return port

    def input(self, name) -> InputPort:
        return self.inputs[str(name)]

    def output(self, name) -> OutputPort:
        return self.outputs[str(name)]

    # -- calls / signals / slots / probes -------------------------------- #
    def call(self, name: str, *args):
        """Invoke a registered call by reference-style camelCase name or
        python snake_case name (reference: registerCall/registerCallable)."""
        fn = getattr(self, name, None) or getattr(self, _snake(name), None)
        if fn is None or not callable(fn):
            raise AttributeError(f"{self.name} has no call {name!r}")
        return fn(*args)

    def register_signal(self, name: str) -> None:
        self._signals.setdefault(name, [])

    def emit_signal(self, name: str, *args) -> None:
        if self._emit_queue is not None:  # deferred during topology commit
            self._emit_queue.append((self, name, args))
            return
        for (blk, slot) in self._signals.get(name, ()):
            blk.call(slot, *args)

    def connect_signal(self, name: str, block: "Block", slot: str) -> None:
        self._signals.setdefault(name, []).append((block, slot))

    def register_probe(self, name: str, getter: Optional[str] = None) -> None:
        """Expose getter ``name`` as probe: ``probe<Name>()`` evaluates and
        emits ``<name>Triggered(value)`` (reference: registerProbe,
        utility/SignalProbe.cpp:77-78)."""
        self._probes[name] = getter or name
        self.register_signal(name + "Triggered")

    def probe(self, name: str):
        value = self.call(self._probes[name])
        self.emit_signal(name + "Triggered", value)
        return value

    # -- lifecycle -------------------------------------------------------- #
    def activate(self) -> None:  # override
        pass

    def deactivate(self) -> None:  # override
        pass

    def is_active(self) -> bool:
        return self._active

    # -- work ------------------------------------------------------------- #
    def work(self) -> None:  # override
        pass

    def work_info(self) -> WorkInfo:
        return WorkInfo(self)

    def wants_work(self) -> bool:
        """Scheduler hint: does this block plausibly have something to do?"""
        if self.unbounded_source:
            return self._source_quota > 0
        if not self.inputs:  # finite source: override wants_work/work
            return False
        for p in self.inputs.values():
            if p.has_message():
                return True
            if p.elements() > 0 and p.elements() >= p.reserve:
                return True
        return False

    def clamp_work_size(self, elems: int) -> int:
        """Clamp a proposed work size to the most congested downstream
        queue's free space (never below 1 so progress is always possible;
        full queues are handled by the scheduler's congestion gate)."""
        spaces = [s for s in (o.free_space() for o in self.outputs.values())
                  if s is not None]
        if spaces:
            return min(elems, max(min(spaces), 1))
        return elems

    def jit(self, fn: Callable, **jit_kwargs) -> Callable:
        """``jax.jit(fn)``: a block's kernels run on JAX's default
        device for every stream dtype."""
        import jax

        return jax.jit(fn, **jit_kwargs)

    def downstream_congested(self) -> bool:
        """True when any downstream input queue is at/over capacity; the
        executor then skips this block until the consumer drains."""
        for out in self.outputs.values():
            for port in out.downstream:
                if port.congested():
                    return True
        return False

    # -- label propagation ------------------------------------------------ #
    def _propagate(self, port: InputPort, labels: List[Label]) -> None:
        self.propagate_labels(port, labels)

    def propagate_labels(self, port: InputPort, labels: List[Label]) -> None:
        """Default: forward each consumed label to every output port at the
        same relative index (reference: Pothos default propagateLabels)."""
        for out in self.outputs.values():
            for lb in labels:
                out.post_label(lb)

    def __repr__(self):
        return f"<{type(self).__name__} {self.name}>"
