"""PHY framing & synchronization blocks (reference: digital/ module).

/comms/preamble_framer, /comms/preamble_correlator, /comms/frame_insert,
/comms/frame_sync — plus the Hamming(8,4)/checksum8 header codec shared
with the frame inserter (reference: digital/FrameHelper.hpp).

Note on frame_sync: the reference walks candidate offsets one
sample at a time with early exit (FrameSync.cpp:470-497). Here the
per-offset quantities (envelope windows, frequency estimate, dechirped
correlation) are computed for ALL offsets at once with prefix sums and a
batched windowed correlation; only the tiny acceptance automaton and the
one-off header decode stay scalar. Same numerics, data-parallel shape.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from pothoscomms_tpu.core.block import Block
from pothoscomms_tpu.core.dtypes import DType
from pothoscomms_tpu.core.labels import Label
from pothoscomms_tpu.core.registry import register_block

# The exact number of bits of an encoded header (FrameHelper.hpp:9)
NUM_HEADER_BITS = 2 + (8 + 12 + 8) * 2
CORR_MAG_PERCENT = 0.7
CORR_DUR_PERCENT = 0.5


# ---------------------------------------------------------------------- #
# Header codec (reference: digital/FrameHelper.hpp)
# ---------------------------------------------------------------------- #
def checksum8(data) -> int:
    """Rotate-add 8-bit checksum (FrameHelper.hpp:18-27)."""
    acc = 0
    for b in data:
        acc = ((acc >> 1) | ((acc & 1) << 7)) & 0xFF
        acc = (acc + int(b)) & 0xFF
    return acc


def header_checksum(header_id: int, length: int) -> int:
    return checksum8([header_id & 0xFF, length & 0xFF, (length >> 8) & 0xFF])


def encode_hamming84(x: int) -> np.ndarray:
    d = [(x >> i) & 1 for i in range(4)]
    return np.array([
        (d[0] + d[1] + d[3]) & 1,
        (d[0] + d[2] + d[3]) & 1,
        d[0],
        (d[1] + d[2] + d[3]) & 1,
        d[1],
        d[2],
        d[3],
        (d[0] + d[1] + d[2]) & 1,
    ], np.uint8)


def decode_hamming84(b) -> tuple:
    """Returns (nibble, error) with single-bit correction
    (FrameHelper.hpp:82-120)."""
    b = [int(v) & 1 for v in b]
    p0 = (b[0] + b[2] + b[4] + b[6]) & 1
    p1 = (b[1] + b[2] + b[5] + b[6]) & 1
    p2 = (b[3] + b[4] + b[5] + b[6]) & 1
    p3 = sum(b[:8]) & 1
    parity = p0 | (p1 << 1) | (p2 << 2) | (p3 << 3)
    error = False
    if parity == 0:
        pass
    elif parity < 8:
        error = True
    else:
        flip = {8: 7, 9: 0, 10: 1, 11: 2, 12: 3, 13: 4, 14: 5, 15: 6}[parity]
        b[flip] ^= 1
    nibble = b[2] | (b[4] << 1) | (b[5] << 2) | (b[6] << 3)
    return nibble, error


def encode_header_word(header_id: int, length: int, chksum: int) -> np.ndarray:
    """58 header bits: 2 sync + Hamming84 x {id, length(12), chksum}
    (FrameHelper.hpp:126-144)."""
    bits = [np.array([0, 1], np.uint8)]
    bits.append(encode_hamming84(header_id & 0xF))
    bits.append(encode_hamming84((header_id >> 4) & 0xF))
    bits.append(encode_hamming84(length & 0xF))
    bits.append(encode_hamming84((length >> 4) & 0xF))
    bits.append(encode_hamming84((length >> 8) & 0xF))
    bits.append(encode_hamming84(chksum & 0xF))
    bits.append(encode_hamming84((chksum >> 4) & 0xF))
    return np.concatenate(bits)


def decode_header_word(bits) -> dict:
    """Inverse of encode_header_word; returns {id, length, chksum, error}."""
    error = False
    vals = []
    for k in range(7):
        nib, err = decode_hamming84(bits[2 + 8 * k: 10 + 8 * k])
        error = error or err
        vals.append(nib)
    hdr_id = vals[0] | (vals[1] << 4)
    length = vals[2] | (vals[3] << 4) | (vals[4] << 8)
    chksum = vals[5] | (vals[6] << 4)
    return {"id": hdr_id, "length": length, "chksum": chksum, "error": error}


# ---------------------------------------------------------------------- #
# /comms/preamble_framer (reference: digital/PreambleFramer.cpp)
# ---------------------------------------------------------------------- #
@register_block("/comms/preamble_framer", "/blocks/preamble_framer")
class PreambleFramer(Block):
    """Splices a preamble ahead of each frameStart label and zero padding
    after frameEnd; labels re-indexed past insertions (reference
    :139-211)."""

    def __init__(self):
        super().__init__()
        self.setup_input(0, DType.parse("uint8"))
        self.setup_output(0, DType.parse("uint8"))
        self.set_preamble([1])
        self.set_frame_start_id("frameStart")
        self.set_frame_end_id("")
        self._padding = np.zeros(0, np.uint8)

    def set_preamble(self, preamble):
        preamble = np.asarray(preamble, np.uint8)
        if preamble.size == 0:
            raise ValueError("preamble cannot be empty")
        self._preamble = preamble

    def get_preamble(self):
        return self._preamble

    def set_frame_start_id(self, label_id: str):
        self._frame_start_id = label_id

    def get_frame_start_id(self) -> str:
        return self._frame_start_id

    def set_frame_end_id(self, label_id: str):
        self._frame_end_id = label_id

    def get_frame_end_id(self) -> str:
        return self._frame_end_id

    def set_padding_size(self, size: int):
        self._padding = np.zeros(int(size), np.uint8)

    def get_padding_size(self) -> int:
        return len(self._padding)

    def _insertion(self, label) -> Optional[np.ndarray]:
        """Buffer to splice in for a start label (overridden by
        FrameInsert)."""
        return self._preamble

    def work(self):
        port = self.input(0)
        out = self.output(0)
        n = port.elements()
        if n == 0:
            return
        buf = np.asarray(port.buffer(n))
        labels = sorted(
            [lb for lb in port.labels if lb.index < n],
            key=lambda l: l.index,
        )
        pieces: List[np.ndarray] = []
        consumed = 0
        offset = 0  # label index shift from insertions so far
        out_labels: List[Label] = []
        last_found = -1
        for lb in labels:
            if last_found != -1 and lb.index != last_found:
                last_found = -1
                offset += len(self._preamble)
            if self._frame_start_id and lb.id == self._frame_start_id:
                head = buf[consumed: lb.index]
                if head.size:
                    pieces.append(head)
                pieces.append(self._insertion(lb))
                consumed = lb.index
                last_found = lb.index
            elif self._frame_end_id and lb.id == self._frame_end_id:
                end = min(lb.index + lb.width, n)
                head = buf[consumed: end]
                if head.size:
                    pieces.append(head)
                pieces.append(self._padding)
                consumed = end
                offset += len(self._padding)
            out_labels.append(
                Label(lb.id, lb.data, lb.index + offset, lb.width)
            )
        if consumed < n:
            pieces.append(buf[consumed:])
        # labels are rewritten here; propagate_labels is a no-op
        # (reference PreambleFramer.cpp:218-221)
        kept = [lb.shifted(-n) for lb in port.labels if lb.index >= n]
        port.labels = []
        port.consume(n)
        port.labels = kept
        data = np.concatenate(pieces) if pieces else np.zeros(0, buf.dtype)
        out.post(data, out_labels)

    def propagate_labels(self, port, labels):
        pass


# ---------------------------------------------------------------------- #
# /comms/frame_insert (reference: digital/FrameInsert.cpp)
# ---------------------------------------------------------------------- #
@register_block("/comms/frame_insert", "/blocks/frame_insert")
class FrameInsert(Block):
    """TX PHY header inserter for complex streams: preamble = symbolWidth-
    repeated preamble symbols + BPSK-encoded 58-bit header
    (reference :222-246, :297-311)."""

    def __init__(self, dtype="complex_float32"):
        super().__init__()
        self.dtype = DType.parse(dtype)
        if not (self.dtype.is_complex and self.dtype.is_float):
            raise ValueError("frame_insert supports complex float dtypes")
        self.setup_input(0, self.dtype)
        self.setup_output(0, self.dtype)
        self._header_id = 0x55
        self._symbol_width = 20
        self._preamble = np.asarray([1], self.dtype.np)
        self._frame_start_id = "frameStart"
        self._frame_end_id = "frameEnd"
        self._padding = np.zeros(0, self.dtype.np)
        self._update_preamble_buffer()

    def set_preamble(self, preamble):
        preamble = np.asarray(preamble, self.dtype.np)
        if preamble.size == 0:
            raise ValueError("preamble cannot be empty")
        self._preamble = preamble
        self._update_preamble_buffer()

    def get_preamble(self):
        return self._preamble

    def set_header_id(self, hid: int):
        self._header_id = int(hid) & 0xFF

    def get_header_id(self) -> int:
        return self._header_id

    def set_symbol_width(self, width: int):
        if width == 0:
            raise ValueError("symbol width cannot be 0")
        self._symbol_width = int(width)
        self._update_preamble_buffer()

    def get_symbol_width(self) -> int:
        return self._symbol_width

    def set_frame_start_id(self, label_id: str):
        self._frame_start_id = label_id

    def get_frame_start_id(self) -> str:
        return self._frame_start_id

    def set_frame_end_id(self, label_id: str):
        self._frame_end_id = label_id

    def get_frame_end_id(self) -> str:
        return self._frame_end_id

    def set_padding_size(self, size: int):
        self._padding = np.zeros(int(size), self.dtype.np)

    def get_padding_size(self) -> int:
        return len(self._padding)

    def _update_preamble_buffer(self):
        self._sync_word_width = self._symbol_width * len(self._preamble)
        self._preamble_buff = np.zeros(
            self._sync_word_width + NUM_HEADER_BITS, self.dtype.np
        )
        self._preamble_buff[: self._sync_word_width] = np.repeat(
            self._preamble, self._symbol_width
        )

    def _frame_buffer(self, label) -> np.ndarray:
        buff = self._preamble_buff.copy()
        length = 0
        if label.data is not None:
            try:
                length = int(label.data) * label.width
            except (TypeError, ValueError):
                length = 0
        chksum = header_checksum(self._header_id, length)
        bits = encode_header_word(self._header_id, length, chksum)
        sym = self._preamble[-1]
        bpsk = np.where(bits != 0, sym, -sym)
        buff[self._sync_word_width:] = bpsk
        return buff

    def work(self):
        port = self.input(0)
        out = self.output(0)
        n = port.elements()
        if n == 0:
            return
        buf = np.asarray(port.buffer(n))
        labels = sorted(
            [lb for lb in port.labels if lb.index < n], key=lambda l: l.index
        )
        pieces: List[np.ndarray] = []
        out_labels: List[Label] = []
        consumed = 0
        offset = 0
        last_found = -1
        for lb in labels:
            if last_found != -1 and lb.index != last_found:
                last_found = -1
                offset += len(self._preamble_buff)
            if self._frame_start_id and lb.id == self._frame_start_id:
                head = buf[consumed: lb.index]
                if head.size:
                    pieces.append(head)
                pieces.append(self._frame_buffer(lb))
                consumed = lb.index
                last_found = lb.index
            elif self._frame_end_id and lb.id == self._frame_end_id:
                end = min(lb.index + lb.width, n)
                head = buf[consumed: end]
                if head.size:
                    pieces.append(head)
                pieces.append(self._padding)
                consumed = end
                offset += len(self._padding)
            out_labels.append(
                Label(lb.id, lb.data, lb.index + offset, lb.width)
            )
        if consumed < n:
            pieces.append(buf[consumed:])
        kept = [lb.shifted(-n) for lb in port.labels if lb.index >= n]
        port.labels = []
        port.consume(n)
        port.labels = kept
        data = np.concatenate(pieces) if pieces else np.zeros(0, buf.dtype)
        out.post(data, out_labels)

    def propagate_labels(self, port, labels):
        pass


# ---------------------------------------------------------------------- #
# /comms/preamble_correlator (reference: digital/PreambleCorrelator.cpp)
# ---------------------------------------------------------------------- #
@register_block("/comms/preamble_correlator", "/blocks/preamble_correlator")
class PreambleCorrelator(Block):
    """Sliding Hamming distance (popcount of XOR) of the preamble over the
    stream; posts frameStart at the first post-preamble element when
    distance <= threshold (reference :130-151). Vectorized: the whole
    distance profile in one shot."""

    DOC = {
        "category": "/Digital",
        "keywords": ["preamble", "correlator", "hamming", "frame"],
        "params": {
            "preamble": {"label": "Preamble", "default": [1]},
            "threshold": {"label": "Threshold", "default": 0,
                          "units": "bits",
                          "widget": "SpinBox(minimum=0)"},
            "frame_start_id": {"label": "Frame Start ID",
                               "default": "frameStart"},
        },
    }

    def __init__(self):
        super().__init__()
        self.setup_input(0, DType.parse("uint8"))
        self.setup_output(0, DType.parse("uint8"))
        self.set_preamble([1])
        self.set_threshold(1)
        self.set_frame_start_id("frameStart")

    def set_preamble(self, preamble):
        preamble = np.asarray(preamble, np.uint8)
        if preamble.size == 0:
            raise ValueError("preamble cannot be empty")
        self._preamble = preamble
        self._profile = None  # rebuilt on next work()

    def get_preamble(self):
        return self._preamble

    def set_threshold(self, threshold: int):
        self._threshold = int(threshold)

    def get_threshold(self) -> int:
        return self._threshold

    def set_frame_start_id(self, label_id: str):
        self._frame_start_id = label_id

    def get_frame_start_id(self) -> str:
        return self._frame_start_id

    def work(self):
        from pothoscomms_tpu.ops.framing import bucket_len, make_hamming_profile

        port = self.input(0)
        out = self.output(0)
        p = len(self._preamble)
        port.set_reserve(p + 1)
        if port.elements() <= p:
            return
        total = port.elements()
        n = total - p  # processable elements; last p stay as lookahead
        buf = np.asarray(port.buffer(total))
        # sliding XOR popcount as a device bit-plane correlation
        # (ops/framing.py; reference PreambleCorrelator.cpp:130-151)
        if self._profile is None:
            self._profile = make_hamming_profile(self._preamble)
        lp = bucket_len(total, minimum=max(2 * p, 64))
        xpad = np.zeros(lp, np.float32)
        xpad[:total] = buf
        dist = self._profile(xpad, lp - p + 1)[:n]
        hits = np.nonzero(dist <= self._threshold)[0]
        for h in hits:
            out.post_label(Label(self._frame_start_id, None, int(h) + p))
        port.consume(n)
        out.post(buf[:n].copy())


# ---------------------------------------------------------------------- #
# Header-bit recovery (reference FrameSync.cpp:699-743) — shared by the
# FrameSync block and the channel-sharded link (parallel/link.py)
# ---------------------------------------------------------------------- #
def process_header_bits(x: np.ndarray, delta_fc, scale, phase_off,
                        sync_word_width: int, symbol_width: int,
                        data_width: int, frame_width: int,
                        last_preamble_sym) -> tuple:
    """Optimal bit-sampling-offset search + BPSK header decode; returns
    (first_bit, fields or None)."""
    sw, dw, fw = sync_word_width, data_width, frame_width
    sym = np.conj(last_preamble_sym)
    first_bit = sw + dw // 2
    first_bit_peak = 0.0
    start = sw - (dw * symbol_width) // 2
    for i in range(start, fw):
        bit = x[i] * scale * np.exp(1j * (phase_off + delta_fc * i)) * sym
        if bit.real > first_bit_peak:
            if first_bit_peak == 0:
                continue
            break
        first_bit = i
        first_bit_peak = bit.real
    if first_bit_peak == 0:
        return first_bit, None
    idx = first_bit + dw * np.arange(NUM_HEADER_BITS)
    rot = scale * np.exp(1j * (phase_off + delta_fc * idx))
    bits = ((x[idx] * rot * sym).real > 0).astype(np.uint8)
    return first_bit, decode_header_word(bits)


# ---------------------------------------------------------------------- #
# Frame acceptance automaton (reference FrameSync.cpp:488-536) — shared
# by the FrameSync block and the channel-sharded link (parallel/link.py)
# ---------------------------------------------------------------------- #
def new_sync_state() -> dict:
    return {
        "max_corr_peak": 0,
        "count_since_max": 0,
        "delta_fc_max": 0.0,
        "phase_off_max": 0.0,
        "scale_at_max": 0.0,
    }


def run_sync_automaton_scalar(state: dict, arrays, mag_thresh: int,
                              dur_thresh: int, try_decode):
    """Reference-shaped per-offset walk (FrameSync.cpp:488-502) — kept
    as the oracle for the event-driven version below (differential
    tests in tests/test_framing.py)."""
    scale, delta_fc, phase_off, corr_peak = arrays
    n = len(corr_peak)
    for i in range(n):
        cp = int(corr_peak[i])
        if cp > state["max_corr_peak"] and cp > mag_thresh:
            state["max_corr_peak"] = cp
            state["count_since_max"] = 0
            state["delta_fc_max"] = float(delta_fc[i])
            state["phase_off_max"] = float(phase_off[i])
            state["scale_at_max"] = float(scale[i])
        state["count_since_max"] += 1
        if state["max_corr_peak"] < mag_thresh:
            continue
        if state["count_since_max"] < dur_thresh:
            continue
        state["max_corr_peak"] = 0
        frame_offset = i - state["count_since_max"]
        if frame_offset < 0:
            # peak carried over from a previous work() call: the frame
            # head is no longer in this buffer, so a decode would index
            # from the array end and read garbage — skip it (shared
            # guard for both callers: FrameSync and parallel/link.py)
            continue
        result = try_decode(frame_offset, state)
        if result is not None:
            return i, frame_offset, result
    return None


def run_sync_automaton(state: dict, arrays, mag_thresh: int, dur_thresh: int,
                       try_decode):
    """Walk the per-offset search arrays with the reference's peak
    acceptance rules (magnitude >= 70% of sync width, duration >= 50% —
    FrameSync.cpp:488-502, FrameHelper.hpp:11-13). At each accepted peak,
    ``try_decode(frame_offset, state)`` attempts the header decode; a
    non-None result stops the walk. Returns (i, frame_offset, result) or
    None when the arrays are exhausted. ``state`` persists across calls
    (streaming).

    Event-driven equivalent of the reference's per-sample loop: almost
    every offset fails ``cp > mag_thresh`` and only increments the
    duration counter, so Python touches only *candidate* offsets
    (numpy ``nonzero`` pre-pass) and acceptance points — interior runs
    advance the counter arithmetically. Exact-equivalence oracle:
    :func:`run_sync_automaton_scalar`."""
    scale, delta_fc, phase_off, corr_peak = arrays
    cp_arr = np.asarray(corr_peak)
    n = len(cp_arr)
    cand = np.nonzero(cp_arr > mag_thresh)[0]
    ncand = len(cand)
    ci = 0
    i = 0

    def set_max(j: int) -> None:
        # scalar steps 1+2 at a new-max index: reset count, then +1
        state["max_corr_peak"] = int(cp_arr[j])
        state["count_since_max"] = 1
        state["delta_fc_max"] = float(delta_fc[j])
        state["phase_off_max"] = float(phase_off[j])
        state["scale_at_max"] = float(scale[j])

    def do_accept(i_acc: int):
        state["max_corr_peak"] = 0
        frame_offset = i_acc - state["count_since_max"]
        if frame_offset < 0:
            return None  # peak carried over from a previous work()
        result = try_decode(frame_offset, state)
        if result is None:
            return None
        return (i_acc, frame_offset, result)

    while i < n:
        while ci < ncand and cand[ci] < i:
            ci += 1
        if state["max_corr_peak"] < mag_thresh:
            # no pending peak: every non-candidate index is a pure
            # counter increment — jump to the next candidate
            if ci >= ncand:
                state["count_since_max"] += n - i
                return None
            j = int(cand[ci])
            ci += 1
            state["count_since_max"] += j - i
            set_max(j)
            i = j + 1
            if state["count_since_max"] >= dur_thresh:
                out = do_accept(j)
                if out is not None:
                    return out
            continue
        # pending peak: the next event is either a LARGER candidate
        # (resets the duration count) or the acceptance index where the
        # count reaches dur_thresh — whichever comes first
        c = state["count_since_max"]
        accept_i = i + (dur_thresh - c - 1)
        j = None
        cj = ci
        lim = min(accept_i, n - 1)
        while cj < ncand and cand[cj] <= lim:
            if int(cp_arr[cand[cj]]) > state["max_corr_peak"]:
                j = int(cand[cj])
                ci = cj + 1
                break
            cj += 1
        if j is not None:
            set_max(j)
            i = j + 1
            if state["count_since_max"] >= dur_thresh:
                out = do_accept(j)
                if out is not None:
                    return out
            continue
        if accept_i >= n:
            state["count_since_max"] += n - i
            return None
        state["count_since_max"] = dur_thresh
        out = do_accept(accept_i)
        i = accept_i + 1
        if out is not None:
            return out
    return None


# ---------------------------------------------------------------------- #
# /comms/frame_sync (reference: digital/FrameSync.cpp)
# ---------------------------------------------------------------------- #
@register_block("/comms/frame_sync", "/blocks/frame_sync")
class FrameSync(Block):
    """RX frame synchronizer. See module docstring for the data-parallel
    restructuring; numerics follow FrameSync.cpp:595-743."""

    DOC = {
        "category": "/Digital",
        "keywords": ["preamble", "frame", "sync", "timing", "recovery"],
        "params": {
            "output_mode": {
                "label": "Output Mode",
                "options": [
                    {"label": "Raw", "value": "RAW"},
                    {"label": "Phase Correction", "value": "PHASE"},
                    {"label": "Timing Recovery", "value": "TIMING"},
                    {"label": "Debug", "value": "DEBUG"},
                ],
                "default": "RAW",
            },
            "preamble": {"label": "Preamble", "default": [1]},
            "header_id": {"label": "Header ID", "default": 0x55},
            "symbol_width": {"label": "Symbol Width", "default": 20,
                             "units": "samples",
                             "widget": "SpinBox(minimum=1)"},
            "data_width": {"label": "Data Width", "default": 4,
                           "units": "samples",
                           "widget": "SpinBox(minimum=2)"},
            "frame_start_id": {"label": "Frame Start ID",
                               "default": "frameStart"},
            "frame_end_id": {"label": "Frame End ID", "default": ""},
            "phase_offset_id": {"label": "Phase Offset ID",
                                "default": ""},
            "input_threshold": {"label": "Input Threshold",
                                "default": 0.01,
                                "desc": "Activity level below which the "
                                        "search is skipped."},
        },
    }

    def __init__(self, dtype="complex_float32"):
        super().__init__()
        self.dtype = DType.parse(dtype)
        if not (self.dtype.is_complex and self.dtype.is_float):
            raise ValueError("frame_sync supports complex float dtypes")
        self.setup_input(0, self.dtype)
        self.setup_output(0, self.dtype)
        self._header_id = 0x55
        self._output_mode = "RAW"
        self._symbol_width = 20
        self._data_width = 4
        self._preamble = np.asarray([1], self.dtype.np)
        self._frame_start_id = "frameStart"
        self._frame_end_id = ""
        self._phase_offset_id = ""
        self._input_threshold = 0.01
        self._verbose = False
        self._update_settings()
        self.activate()

    # -- setters ---------------------------------------------------------- #
    def set_output_mode(self, mode: str):
        if mode not in ("RAW", "PHASE", "TIMING", "DEBUG"):
            raise ValueError(f"unknown output mode {mode}")
        self._output_mode = mode

    def get_output_mode(self) -> str:
        return self._output_mode

    def set_preamble(self, preamble):
        preamble = np.asarray(preamble, self.dtype.np)
        if preamble.size == 0:
            raise ValueError("preamble cannot be empty")
        self._preamble = preamble
        self._update_settings()

    def get_preamble(self):
        return self._preamble

    def set_header_id(self, hid: int):
        self._header_id = int(hid) & 0xFF

    def get_header_id(self) -> int:
        return self._header_id

    def set_symbol_width(self, width: int):
        if width == 0:
            raise ValueError("symbol width cannot be 0")
        self._symbol_width = int(width)
        self._update_settings()

    def get_symbol_width(self) -> int:
        return self._symbol_width

    def set_data_width(self, width: int):
        if width < 2:
            raise ValueError("data width should be at least 2 samples per symbol")
        self._data_width = int(width)
        self._update_settings()

    def get_data_width(self) -> int:
        return self._data_width

    def set_frame_start_id(self, label_id: str):
        self._frame_start_id = label_id

    def get_frame_start_id(self) -> str:
        return self._frame_start_id

    def set_frame_end_id(self, label_id: str):
        self._frame_end_id = label_id

    def get_frame_end_id(self) -> str:
        return self._frame_end_id

    def set_phase_offset_id(self, label_id: str):
        self._phase_offset_id = label_id

    def get_phase_offset_id(self) -> str:
        return self._phase_offset_id

    # reference camelCase alias setPhaseOffsetID
    setPhaseOffsetID = set_phase_offset_id

    def set_input_threshold(self, threshold: float):
        if threshold < 0:
            raise ValueError("threshold should be non-negative")
        self._input_threshold = float(threshold)
        self._search = None

    def get_input_threshold(self) -> float:
        return self._input_threshold

    def set_verbose_mode(self, enb: bool):
        self._verbose = bool(enb)

    def _update_settings(self):
        self._search = None  # device search kernel rebuilt on next work()
        self._sync_word_width = (
            self._symbol_width * self._data_width * len(self._preamble)
        )
        self._frame_width = self._sync_word_width + NUM_HEADER_BITS * self._data_width
        self._corr_mag_thresh = int(self._sync_word_width * CORR_MAG_PERCENT)
        self._corr_dur_thresh = int(self._sync_word_width * CORR_DUR_PERCENT)

    def activate(self):
        self._auto = new_sync_state()
        self._remaining_payload = 0
        self._scale_at_max = 0.0
        self._phase = 0.0
        self._phase_inc = 0.0

    # -- vectorized per-offset search (device kernel) --------------------- #
    def _search_arrays(self, x: np.ndarray, n: int):
        """Compute (scale, delta_fc, phase_off, corr_peak) for offsets
        0..n-1 over x (len >= n + frame_width - 1).

        Runs the jitted planar kernel ops/framing.sync_search_planar —
        one fixed-shape device program (input bucketed to a power of two
        so recompilation stays bounded), replacing the reference's
        per-sample host loop (FrameSync.cpp:470-497)."""
        from pothoscomms_tpu.ops.framing import bucket_len, make_sync_search
        from pothoscomms_tpu.parallel import cplx

        if self._search is None:
            self._search = make_sync_search(
                self._preamble, self._symbol_width, self._data_width,
                NUM_HEADER_BITS, self._input_threshold,
            )
        lp = bucket_len(len(x), minimum=max(2 * self._frame_width, 1024))
        xpad = np.zeros((lp, 2), np.float32)
        xpad[: len(x)] = cplx.to_planar(x)
        n_pad = lp - self._frame_width + 1
        scale, delta_fc, phase_off, corr_peak = self._search(xpad, n_pad)
        return scale[:n], delta_fc[:n], phase_off[:n], corr_peak[:n]

    def _process_header_bits(self, x: np.ndarray, delta_fc, scale, phase_off):
        return process_header_bits(
            x, delta_fc, scale, phase_off, self._sync_word_width,
            self._symbol_width, self._data_width, self._frame_width,
            self._preamble[-1],
        )

    def work(self):
        port = self.input(0)
        out = self.output(0)
        avail = port.elements()
        if avail == 0:
            return
        x = np.asarray(port.buffer(avail))
        mode = self._output_mode

        # payload forwarding (reference :401-457)
        if self._remaining_payload != 0:
            if mode == "RAW":
                n = min(self._remaining_payload, avail)
                out.post(x[:n] * self._scale_at_max)
                self._remaining_payload -= n
                port.consume(n)
                return
            if mode in ("PHASE", "DEBUG"):
                n = min(self._remaining_payload, avail)
                ph = self._phase + self._phase_inc * np.arange(n)
                out.post((x[:n] * self._scale_at_max * np.exp(1j * ph)).astype(
                    self.dtype.np))
                self._phase += self._phase_inc * n
                self._remaining_payload -= n
                port.consume(n)
                return
            if mode == "TIMING":
                dw = self._data_width
                n = min(self._remaining_payload, avail) // dw
                if n == 0:
                    port.set_reserve(dw)
                    return
                syms = x[: n * dw: dw]
                ph = self._phase + self._phase_inc * dw * np.arange(n)
                out.post((syms * self._scale_at_max * np.exp(1j * ph)).astype(
                    self.dtype.np))
                self._phase += self._phase_inc * dw * n
                consumed = n * dw
                self._remaining_payload -= consumed
                port.consume(consumed)
                return

        # correlation search (reference :462-589)
        require = self._frame_width
        if avail < require:
            port.set_reserve(require)
            return
        n = avail - require + 1
        arrays = self._search_arrays(x, n)

        def try_decode(frame_offset, st):
            """Header decode + validity checks (reference :533-536);
            None keeps the automaton walking."""
            first_bit, fields = self._process_header_bits(
                x[frame_offset:], st["delta_fc_max"], st["scale_at_max"],
                st["phase_off_max"],
            )
            if fields is None or fields["error"]:
                return None
            if fields["chksum"] != header_checksum(fields["id"],
                                                   fields["length"]):
                return None
            if fields["id"] != self._header_id:
                return None
            if fields["length"] == 0:
                return None
            return first_bit, fields["length"]

        hit = run_sync_automaton(self._auto, arrays, self._corr_mag_thresh,
                                 self._corr_dur_thresh, try_decode)
        if hit is None:
            port.consume(n)
            return
        _, frame_offset, (first_bit, length) = hit

        label_width = 1 if mode == "TIMING" else self._data_width
        payload_offset = (frame_offset + first_bit
                          + NUM_HEADER_BITS * self._data_width
                          + label_width // 2)
        label_start = 0
        label_end = (length - 1) * label_width
        self._remaining_payload = length * self._data_width
        self._phase_inc = self._auto["delta_fc_max"]
        self._phase = (self._auto["phase_off_max"]
                       + self._phase_inc * self._frame_width)
        self._scale_at_max = self._auto["scale_at_max"]
        if mode == "DEBUG":
            backup = min(payload_offset, self._frame_width)
            label_start += backup
            label_end += backup
            self._phase -= self._phase_inc * backup
            self._remaining_payload += backup
            payload_offset -= backup

        if self._phase_offset_id:
            out.post_label(Label(self._phase_offset_id, self._phase,
                                 label_start, label_width))
        if self._frame_start_id:
            out.post_label(Label(self._frame_start_id, length,
                                 label_start, label_width))
        if self._frame_end_id:
            out.post_label(Label(self._frame_end_id, length,
                                 label_end, label_width))
        port.set_reserve(0)
        port.consume(payload_offset)

    def propagate_labels(self, port, labels):
        pass  # labels from input discarded (reference :309-318)
