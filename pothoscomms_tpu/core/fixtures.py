"""Test-fixture blocks.

the equivalents of the Pothos-core test blocks every reference test
uses: ``/blocks/feeder_source``, ``/blocks/collector_sink``,
``/blocks/vector_source``, ``/blocks/copier``, ``/blocks/black_hole``
(reference usage: math/TestArithmeticBlocks.cpp:519-543,
digital/TestFramerToCorrelator.cpp:22-26).
"""

from __future__ import annotations

import collections
from typing import Any, List, Optional

import numpy as np

from pothoscomms_tpu.core.block import Block
from pothoscomms_tpu.core.dtypes import DType
from pothoscomms_tpu.core.labels import Label
from pothoscomms_tpu.core.packet import Packet
from pothoscomms_tpu.core.registry import register_block


@register_block("/blocks/feeder_source", "/comms_tpu/feeder_source")
class FeederSource(Block):
    """Queue of buffers/labels/packets/messages fed downstream one item per
    work() call."""

    def __init__(self, dtype="float32"):
        super().__init__()
        self.dtype = DType.parse(dtype)
        self.setup_output(0, self.dtype)
        self._queue: collections.deque = collections.deque()

    def feed_buffer(self, arr, labels: Optional[List[Label]] = None):
        if type(arr).__name__ != "DeviceChunk":  # device data stays put
            arr = np.ascontiguousarray(arr)
        self._queue.append(("buffer", arr, labels or []))

    def feed_label(self, label: Label):
        self._queue.append(("label", label))

    def feed_packet(self, pkt: Packet):
        self._queue.append(("packet", pkt))

    def feed_message(self, msg: Any):
        self._queue.append(("message", msg))

    def feed_test_plan(self, plan: dict) -> dict:
        """Randomized buffer plan; returns {'expected': np.ndarray}
        (analog of the reference feeder's feedTestPlan json —
        digital/TestFramerToCorrelator.cpp:51-58)."""
        rng = np.random.default_rng(plan.get("seed", 0))
        n_buffs = rng.integers(
            plan.get("minBuffers", 1), plan.get("maxBuffers", 8) + 1
        )
        lo = plan.get("minValue", 0)
        hi = plan.get("maxValue", 100)
        chunks = []
        for _ in range(int(n_buffs)):
            size = int(
                rng.integers(
                    plan.get("minBufferSize", 10), plan.get("maxBufferSize", 100) + 1
                )
            )
            if self.dtype.is_float and not self.dtype.is_complex:
                arr = rng.uniform(lo, hi, size).astype(self.dtype.np)
            elif self.dtype.is_complex and self.dtype.is_float:
                arr = (
                    rng.uniform(lo, hi, size) + 1j * rng.uniform(lo, hi, size)
                ).astype(self.dtype.np)
            else:
                arr = rng.integers(lo, hi, size).astype(self.dtype.np)
            chunks.append(arr)
            self.feed_buffer(arr)
        expected = np.concatenate(chunks) if chunks else np.zeros(0, self.dtype.np)
        return {"expected": expected}

    def wants_work(self) -> bool:
        return len(self._queue) > 0

    def work(self):
        kind, *payload = self._queue.popleft()
        out = self.output(0)
        if kind == "buffer":
            arr, labels = payload
            out.post(arr, labels)
        elif kind == "label":
            out.post_label(payload[0])
        elif kind in ("packet", "message"):
            out.post_message(payload[0])


@register_block("/blocks/collector_sink", "/comms_tpu/collector_sink")
class CollectorSink(Block):
    def __init__(self, dtype="float32"):
        super().__init__()
        self.dtype = DType.parse(dtype)
        self.setup_input(0, self.dtype)
        self._parts: List[np.ndarray] = []
        self._labels: List[Label] = []
        self._collected = 0
        self.packets: List[Packet] = []
        self.messages: List[Any] = []

    def work(self):
        port = self.input(0)
        while port.has_message():
            msg = port.pop_message()
            (self.packets if isinstance(msg, Packet) else self.messages).append(msg)
        n = port.elements()
        if n:
            buf = np.array(port.buffer(n), copy=True)
            # record labels at absolute collected position
            for lb in port.labels:
                if lb.index < n:
                    self._labels.append(lb.shifted(self._collected))
            self._parts.append(buf)
            self._collected += n
            port.labels = [lb for lb in port.labels if lb.index >= n]
            port.consume(n)

    def propagate_labels(self, port, labels):
        pass  # already recorded in work()

    def get_buffer(self) -> np.ndarray:
        if not self._parts:
            shape = (0,) + self.dtype.storage_shape_suffix
            return np.zeros(shape, self.dtype.np)
        return np.concatenate(self._parts, axis=0)

    def get_labels(self) -> List[Label]:
        return list(self._labels)

    def clear(self):
        self._parts.clear()
        self._labels.clear()
        self.packets.clear()
        self.messages.clear()
        self._collected = 0


@register_block("/blocks/vector_source", "/comms_tpu/vector_source")
class VectorSource(Block):
    """Posts a configured vector of elements, once or repeating."""

    def __init__(self, dtype="float32"):
        super().__init__()
        self.dtype = DType.parse(dtype)
        self.setup_output(0, self.dtype)
        self._elements = np.zeros(0, self.dtype.np)
        self._mode = "ONCE"
        self._start_id = ""
        self._end_id = ""
        self._sent = False

    def set_elements(self, values):
        self._elements = np.asarray(values, dtype=self.dtype.np)
        self._sent = False

    def set_mode(self, mode: str):
        self._mode = mode.upper()

    def set_start_id(self, label_id: str):
        self._start_id = label_id

    def set_end_id(self, label_id: str):
        self._end_id = label_id

    def wants_work(self) -> bool:
        if self._mode == "REPEAT":
            return self._source_quota > 0
        return not self._sent and len(self._elements) > 0

    def work(self):
        labels = []
        n = len(self._elements)
        if self._start_id:
            labels.append(Label(self._start_id, n, 0))
        if self._end_id:
            labels.append(Label(self._end_id, n, n - 1))
        self.output(0).post(self._elements, labels)
        self._sent = True
        if self._mode == "REPEAT":
            self._source_quota = max(0, self._source_quota - n)

    @property
    def unbounded_source(self):
        return self._mode == "REPEAT"

    @unbounded_source.setter
    def unbounded_source(self, v):
        pass


@register_block("/blocks/copier", "/comms_tpu/copier")
class Copier(Block):
    """Forwards the stream, deliberately re-chunking at random boundaries to
    stress consume/produce windowing (the reference inserts /blocks/copier
    for exactly this — digital/TestFramerToCorrelator.cpp:22-26)."""

    def __init__(self, seed: int = 0):
        super().__init__()
        self.setup_input(0)
        self.setup_output(0)
        self._rng = np.random.default_rng(seed)

    def work(self):
        port = self.input(0)
        while port.has_message():
            self.output(0).post_message(port.pop_message())
        n = port.elements()
        if not n:
            return
        take = int(self._rng.integers(1, n + 1))
        buf = np.array(port.buffer(take), copy=True)
        labels = [lb for lb in port.labels if lb.index < take]
        port.consume(take)
        self.output(0).post(buf)

    def propagate_labels(self, port, labels):
        for lb in labels:
            self.output(0).post_label(lb)


@register_block("/blocks/finite_release", "/comms_tpu/finite_release")
class FiniteRelease(Block):
    """Pass-through that forwards a bounded total number of elements then
    drops the rest (Pothos-core test fixture used by
    filter/TestFIRFilter.cpp:25-26)."""

    def __init__(self, total_elements: int = 1024):
        super().__init__()
        self.setup_input(0)
        self.setup_output(0)
        self._total = int(total_elements)
        self._passed = 0

    def set_total_elements(self, total: int):
        self._total = int(total)
        self._passed = 0

    def work(self):
        port = self.input(0)
        while port.has_message():
            self.output(0).post_message(port.pop_message())
        n = port.elements()
        if n == 0:
            return
        take = min(n, self._total - self._passed)
        if take > 0:
            buf = np.array(port.buffer(take), copy=True)
            self.output(0).post(buf, None)
            self._passed += take
        port.consume(n)  # drop any excess beyond the quota


@register_block("/blocks/packet_to_stream", "/comms_tpu/packet_to_stream")
class PacketToStream(Block):
    """Convert packets to a stream with frameStart/frameEnd labels
    (Pothos-core fixture used by digital/TestFramerToCorrelator.cpp)."""

    def __init__(self):
        super().__init__()
        self.setup_input(0)
        self.setup_output(0)
        self._frame_start_id = ""
        self._frame_end_id = ""

    def set_frame_start_id(self, label_id: str):
        self._frame_start_id = label_id

    def set_frame_end_id(self, label_id: str):
        self._frame_end_id = label_id

    def set_name(self, name: str):
        self.name = name

    def work(self):
        port = self.input(0)
        out = self.output(0)
        while port.has_message():
            msg = port.pop_message()
            if not isinstance(msg, Packet):
                out.post_message(msg)
                continue
            payload = np.asarray(msg.payload)
            n = len(payload)
            labels = []
            if self._frame_start_id:
                labels.append(Label(self._frame_start_id, n, 0))
            if self._frame_end_id and n:
                labels.append(Label(self._frame_end_id, n, n - 1))
            out.post(payload, labels)
        # forward any stream data untouched
        n = port.elements()
        if n:
            buf = np.array(port.buffer(n), copy=True)
            port.consume(n)
            out.post(buf)


@register_block("/blocks/stream_to_packet", "/comms_tpu/stream_to_packet")
class StreamToPacket(Block):
    """Extract MTU-sized packets at frameStart labels (Pothos-core
    fixture; inverse of PacketToStream for loopback tests)."""

    def __init__(self):
        super().__init__()
        self.setup_input(0)
        self.setup_output(0)
        self._frame_start_id = ""
        self._mtu = 0

    def set_frame_start_id(self, label_id: str):
        self._frame_start_id = label_id

    def set_mtu(self, mtu: int):
        self._mtu = int(mtu)

    # reference camelCase alias
    setMTU = set_mtu

    def work(self):
        port = self.input(0)
        out = self.output(0)
        n = port.elements()
        if n == 0:
            return
        if not self._frame_start_id:
            port.consume(n)
            return
        # find the first start label with a full MTU available after it
        starts = sorted(
            (lb for lb in port.labels
             if lb.id == self._frame_start_id and lb.index < n),
            key=lambda l: l.index,
        )
        if not starts:
            port.consume(n)  # no frame in sight: drop searched samples
            return
        lb = starts[0]
        if lb.index + self._mtu > n:
            port.set_reserve(lb.index + self._mtu)
            return
        port.set_reserve(0)
        buf = np.asarray(port.buffer(n))
        payload = buf[lb.index: lb.index + self._mtu].copy()
        out.post_message(Packet(payload))
        # consume through the packet, dropping its labels
        port.labels = [l for l in port.labels
                       if not (lb.index <= l.index < lb.index + self._mtu)]
        port.consume(lb.index + self._mtu)

    def propagate_labels(self, port, labels):
        pass


@register_block("/blocks/sporadic_dropper", "/comms_tpu/sporadic_dropper")
class SporadicDropper(Block):
    """Randomly drop packets/messages with a given probability (the
    Pothos-core fault-injection fixture used by the reference's harsh
    LLC test, mac/TestSimpleLlc.cpp:146-151). Seedable for determinism."""

    def __init__(self, seed: Optional[int] = None):
        super().__init__()
        self.setup_input(0)
        self.setup_output(0)
        self._probability = 0.0
        self._rng = np.random.default_rng(seed)

    def set_probability(self, p: float):
        if not (0.0 <= p <= 1.0):
            raise ValueError("probability must be within [0, 1]")
        self._probability = float(p)

    def get_probability(self) -> float:
        return self._probability

    def work(self):
        port = self.input(0)
        while port.has_message():
            msg = port.pop_message()
            if self._rng.random() >= self._probability:
                self.output(0).post_message(msg)
        n = port.elements()
        if n:
            buf = np.array(port.buffer(n), copy=True)
            port.consume(n)
            if self._rng.random() >= self._probability:
                self.output(0).post(buf)


@register_block("/blocks/black_hole", "/comms_tpu/black_hole")
class BlackHole(Block):
    def __init__(self, dtype=None):
        super().__init__()
        self.setup_input(0, dtype)

    def work(self):
        port = self.input(0)
        while port.has_message():
            port.pop_message()
        port.labels.clear()
        port.consume(port.elements())
