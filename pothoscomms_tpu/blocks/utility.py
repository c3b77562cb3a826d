"""Utility blocks (reference: utility/ module, SURVEY.md §2.9).

This file starts with /comms/signal_probe; the remaining scope utilities
(threshold, split/combine complex, wave_trigger) are siblings here.
"""

from __future__ import annotations

import time

import numpy as np

from pothoscomms_tpu.core.block import Block
from pothoscomms_tpu.core.dtypes import DType
from pothoscomms_tpu.core.labels import Label
from pothoscomms_tpu.core.packet import Packet
from pothoscomms_tpu.core.registry import register_block


import functools


@functools.lru_cache(maxsize=8)
def _probe_reduce_fn(mode: str, is_complex: bool):
    """Jit-cached probe reduction over a planar array (see
    SignalProbe._probe_device). Cached at module scope so every probe
    invocation reuses one compiled kernel instead of re-tracing."""
    import jax
    import jax.numpy as jnp

    def f(x):
        if mode == "VALUE":
            return x[-1]
        if mode == "RMS":
            sq = jnp.sum(x * x, axis=-1) if is_complex else x * x
            return jnp.sqrt(jnp.mean(sq))
        return jnp.mean(x, axis=0)  # MEAN

    return jax.jit(f)


@register_block("/comms/signal_probe", "/blocks/stream_probe")
class SignalProbe(Block):
    """VALUE/RMS/MEAN probe over the last <=window elements, wall-clock
    rate limited (reference: utility/SignalProbe.cpp:59-171).

    Probe type is double (complex<double> for complex streams); integer
    samples convert exactly (fromQ with zero shift, :141-157).
    """

    DOC = {
        "category": "/Utility",
        "keywords": ["probe", "value", "rms", "mean"],
        "params": {
            "mode": {
                "label": "Mode",
                "options": [{"label": m.title(), "value": m} for m in
                            ("VALUE", "RMS", "MEAN")],
                "default": "VALUE",
            },
            "window": {"label": "Window", "default": 1024,
                       "units": "elements",
                       "widget": "SpinBox(minimum=1)"},
            "rate": {"label": "Rate", "default": 0.0, "units": "Hz",
                     "desc": "Max probe calculation rate (0 = every "
                             "work call)."},
        },
    }

    def __init__(self, dtype="float32"):
        super().__init__()
        self.dtype = DType.parse(dtype)
        self.setup_input(0, self.dtype)
        self._value = 0.0 + 0.0j if self.dtype.is_complex else 0.0
        self._mode = "VALUE"
        self._window = 1024
        self._rate = 0.0
        self._next_calc = 0.0
        self.register_probe("value")
        self.register_signal("valueChanged")
        self.input(0).set_reserve(1)

    def value(self):
        return self._value

    def set_mode(self, mode: str):
        self._mode = mode

    def get_mode(self) -> str:
        return self._mode

    def set_window(self, window: int):
        self._window = int(window)
        self.input(0).set_reserve(self._window)

    def get_window(self) -> int:
        return self._window

    def set_rate(self, rate: float):
        self._rate = float(rate)

    def get_rate(self) -> float:
        return self._rate

    def activate(self):
        self._next_calc = time.monotonic()

    def _to_probe(self, arr: np.ndarray) -> np.ndarray:
        if self.dtype.is_complex_int:
            return arr[..., 0].astype(np.float64) + 1j * arr[..., 1].astype(
                np.float64
            )
        if self.dtype.is_complex:
            return arr.astype(np.complex128)
        return arr.astype(np.float64)

    def work(self):
        port = self.input(0)
        avail = port.elements()
        if avail == 0:
            return
        n = min(self._window, avail)
        # drain everything (reference consumes the whole buffer per
        # work, SignalProbe.cpp:123-163); probe over the last <=window.
        # take() keeps device-resident chunks un-materialized so a fused
        # upstream segment's throughput isn't gated by a host D2H.
        parts = port.take(avail)

        now = time.monotonic()
        if self._rate != 0.0 and now < self._next_calc:
            return
        if self._rate != 0.0:
            self._next_calc += 1.0 / self._rate

        # gather the LAST n elements from the tail of the parts list
        tail = []
        need = n
        for p in reversed(parts):
            ln = int(p.shape[0])
            t = min(ln, need)
            tail.insert(0, p[ln - t:])
            need -= t
            if need == 0:
                break
        from pothoscomms_tpu.core.fusion import DeviceChunk

        if any(isinstance(p, DeviceChunk) for p in tail):
            self._value = self._probe_device(tail, n)
        else:
            x = self._to_probe(np.concatenate(
                [np.asarray(p) for p in tail]) if len(tail) > 1
                else np.asarray(tail[0]))
            if self._mode == "VALUE":
                self._value = x[n - 1]
            elif self._mode == "RMS":
                self._value = float(np.sqrt(np.mean(np.abs(x) ** 2)))
            elif self._mode == "MEAN":
                self._value = x.mean()
        self.emit_signal("valueChanged", self._value)

    def _probe_device(self, tail, n: int):
        """Device-side reduction over planar chunks: only the probe
        scalar crosses to the host. All array ops go through jitted
        kernels (core/fusion.py)."""
        from pothoscomms_tpu.core.fusion import _concat_fn, to_planar_jax

        planars = [to_planar_jax(p, self.dtype) for p in tail]
        x = planars[0] if len(planars) == 1 else _concat_fn(
            len(planars))(*planars)
        fn = _probe_reduce_fn(self._mode, self.dtype.is_complex)
        out = np.asarray(fn(x))
        if self._mode == "RMS":
            return float(out)
        return (complex(out[0], out[1]) if self.dtype.is_complex
                else float(out))


# ---------------------------------------------------------------------- #
# /comms/threshold (reference: utility/Threshold.cpp)
# ---------------------------------------------------------------------- #
@register_block("/comms/threshold", "/blocks/threshold")
class Threshold(Block):
    """Hysteresis comparator: posts activation/deactivation labels at
    crossing indices and forwards the stream (reference :117-149)."""

    DOC = {
        "category": "/Utility",
        "keywords": ["threshold", "hysteresis", "labels"],
        "params": {
            "activation_level": {"label": "Activation Level",
                                 "default": 0},
            "deactivation_level": {"label": "Deactivation Level",
                                   "default": 0},
            "activation_id": {"label": "Activation ID", "default": ""},
            "deactivation_id": {"label": "Deactivation ID",
                                "default": ""},
        },
    }

    def __init__(self, dtype="float32"):
        super().__init__()
        self.dtype = DType.parse(dtype)
        if self.dtype.is_complex or self.dtype.kind == "uint":
            raise ValueError("threshold supports real signed dtypes")
        self.setup_input(0, self.dtype)
        self.setup_output(0, self.dtype)
        self._activation_level = 0
        self._deactivation_level = 0
        self._activation_id = ""
        self._deactivation_id = ""
        self._active_state = False

    def set_activation_level(self, level):
        self._activation_level = level
        self._bump_fuse_epoch()

    def get_activation_level(self):
        return self._activation_level

    def set_deactivation_level(self, level):
        self._deactivation_level = level
        self._bump_fuse_epoch()

    def get_deactivation_level(self):
        return self._deactivation_level

    def set_activation_id(self, label_id: str):
        self._activation_id = label_id
        self._bump_fuse_epoch()

    def get_activation_id(self) -> str:
        return self._activation_id

    def set_deactivation_id(self, label_id: str):
        self._deactivation_id = label_id
        self._bump_fuse_epoch()

    def get_deactivation_id(self) -> str:
        return self._deactivation_id

    def activate(self):
        self._active_state = False

    def work(self):
        port = self.input(0)
        out = self.output(0)
        n = port.elements()
        if n == 0:
            return
        buf = np.asarray(port.buffer(n))
        # candidate crossing samples; state walk only visits those
        above = buf > self._activation_level
        below = buf < self._deactivation_level
        labels = []
        state = self._active_state
        for i in np.nonzero(above | below)[0]:
            if not state and above[i]:
                state = True
                if self._activation_id:
                    labels.append(Label(self._activation_id, None, int(i)))
            elif state and below[i]:
                state = False
                if self._deactivation_id:
                    labels.append(Label(self._deactivation_id, None, int(i)))
        self._active_state = bool(state)
        port.consume(n)
        out.post(buf.copy(), labels)

    # -- auto-fusion: stream passthrough with device-side state walk --- #
    # Threshold forwards the stream unchanged; the labels exist only
    # when activation/deactivation ids are configured, so an id-less
    # instance fuses (chains containing it stay device-resident). The
    # hysteresis state still advances EXACTLY on device — a later
    # set_activation_id (epoch bump -> disengage) resumes streaming
    # with the correct state. Crossing order ties replicate the
    # streaming walk's branch order (activation checked first).
    def fuse_ready(self) -> bool:
        # overlapping bands (deactivation > activation) make a sample
        # satisfy BOTH conditions and the walk toggles per candidate
        # (parity, not last-candidate) — that config streams
        return (not self._activation_id and not self._deactivation_id
                and self._deactivation_level <= self._activation_level
                and self.dtype.is_float and self.dtype.bits == 32)

    def fuse_label_adjust(self, lb):
        return lb

    def fuse_export(self, channels: int):
        import jax.numpy as jnp

        act = np.float32(self._activation_level)
        deact = np.float32(self._deactivation_level)
        carry = jnp.full((channels, 1),
                         np.float32(1.0 if self._active_state else 0.0))

        def step(carry, x):
            t = x.shape[1]
            idx = jnp.arange(t, dtype=jnp.float32)[None, :]
            above = x > act
            below = x < deact
            # last index where each condition could flip the state;
            # -1 when never. At an equal index the streaming walk
            # checks activation FIRST, so activation wins ties.
            last_a = jnp.max(jnp.where(above, idx, -1.0), axis=1,
                             keepdims=True)
            last_b = jnp.where(above, -1.0, jnp.where(below, idx, -1.0))
            last_d = jnp.max(last_b, axis=1, keepdims=True)
            new = jnp.where(
                (last_a < 0) & (last_d < 0), carry,
                jnp.where(last_a >= last_d, 1.0, 0.0))
            return new, x

        return carry, step

    def fuse_import(self, carry) -> None:
        self._active_state = bool(float(np.asarray(carry)[0, 0]) > 0.5)


# ---------------------------------------------------------------------- #
# /comms/split_complex, /comms/combine_complex
# (reference: utility/SplitComplex.cpp, utility/CombineComplex.cpp)
# ---------------------------------------------------------------------- #
@register_block("/comms/split_complex")
class SplitComplex(Block):
    """complex -> named "re"/"im" output ports (reference :39-66)."""

    def __init__(self, dtype="float32"):
        super().__init__()
        scalar = DType.parse(dtype)
        if scalar.is_complex:
            scalar = scalar.scalar
        self.dtype = DType.parse("complex_" + scalar.name)
        self.scalar = scalar
        self.setup_input(0, self.dtype)
        self.setup_output("re", scalar)
        self.setup_output("im", scalar)

    def work(self):
        port = self.input(0)
        n = port.elements()
        if n == 0:
            return
        buf = np.asarray(port.buffer(n))
        if self.dtype.is_complex_int:
            re, im = buf[..., 0], buf[..., 1]
        else:
            re, im = buf.real, buf.imag
        port.consume(n)
        self.output("re").post(re.astype(self.scalar.np))
        self.output("im").post(im.astype(self.scalar.np))

    # -- auto-fusion: 2-output TAIL splitting the planar planes --------- #
    def fuse_ready(self) -> bool:
        return self.scalar.is_float and self.scalar.bits == 32

    def fuse_label_adjust(self, lb):
        return lb

    def fuse_export(self, channels: int):
        def step(carry, x):
            return carry, (x[..., 0], x[..., 1])

        return (), step

    def fuse_import(self, carry) -> None:
        pass


# ---------------------------------------------------------------------- #
# /comms/wave_trigger (reference: utility/WaveTrigger.cpp)
# ---------------------------------------------------------------------- #
@register_block("/comms/wave_trigger", "/blocks/wave_trigger")
class WaveTrigger(Block):
    """Oscilloscope trigger engine feeding GUI waveform monitors.

    N input ports (aligned or free-running); level trigger with POS/NEG/
    LEVEL slope and sub-sample interpolated position (reference :735-771),
    |x| for complex, or label-ID trigger; AUTOMATIC/SEMIAUTOMATIC/NORMAL/
    PERIODIC/DISABLED modes with event-rate pacing, auto-force timeout and
    hold-off; multi-window back-to-back capture; one Packet per port per
    event with labels + metadata {index, position, level} and a "T" label
    at the trigger point (reference :515-591). The level search itself is
    vectorized (all crossings found in one comparison pass).
    """

    DOC = {
        "category": "/Utility",
        "keywords": ["scope", "oscilloscope", "trigger", "plotter"],
        "params": {
            "mode": {
                "label": "Trigger Mode",
                "options": [{"label": m.title(), "value": m} for m in
                            ("AUTOMATIC", "SEMIAUTOMATIC", "NORMAL",
                             "PERIODIC", "DISABLED")],
                "default": "AUTOMATIC",
            },
            "slope": {
                "label": "Trigger Slope",
                "options": [
                    {"label": "Positive", "value": "POS"},
                    {"label": "Negative", "value": "NEG"},
                    {"label": "Level", "value": "LEVEL"},
                ],
                "default": "POS",
            },
            "level": {"label": "Trigger Level", "default": 0.5},
            "position": {"label": "Position", "default": 128,
                         "units": "samples"},
            "hold_off": {"label": "Hold Off", "default": 1024,
                         "units": "samples"},
            "num_points": {"label": "Num Points", "default": 1024,
                           "widget": "SpinBox(minimum=0)"},
            "num_windows": {"label": "Num Windows", "default": 1},
            "event_rate": {"label": "Event Rate", "default": 1.0,
                           "units": "events/sec"},
            "source": {"label": "Trigger Source", "default": 0},
            "label_id": {"label": "Trigger Label", "default": ""},
            "alignment": {"label": "Alignment", "default": True,
                          "widget": "ToggleSwitch"},
        },
    }

    def __init__(self):
        super().__init__()
        self.setup_input(0)
        self.setup_output(0)
        self._num_points = 1024
        self._num_windows = 1
        self._alignment = True
        self._source = 0
        self._hold_off = 1024
        self._pos_slope = True
        self._neg_slope = False
        self._slope_str = "POS"
        self._mode_str = "AUTOMATIC"
        self._level = 0.5
        self._position = 128
        self._label_id = ""
        self._forward_ids = set()
        self.set_event_rate(1.0)
        self.set_mode("AUTOMATIC")
        self.activate()

    # -- configuration (reference :228-384) ------------------------------- #
    def set_num_ports(self, num_ports: int):
        for i in range(len(self.inputs), num_ports):
            self.setup_input(i)

    def set_num_points(self, num_points: int):
        if num_points == 0:
            raise ValueError("num points must be positive")
        self._num_points = int(num_points)

    def get_num_points(self) -> int:
        return self._num_points

    def set_num_windows(self, num_windows: int):
        if num_windows == 0:
            raise ValueError("num windows must be positive")
        self._num_windows = int(num_windows)

    def get_num_windows(self) -> int:
        return self._num_windows

    def set_alignment(self, enabled: bool):
        self._alignment = bool(enabled)

    def get_alignment(self) -> bool:
        return self._alignment

    def set_hold_off(self, hold_off: int):
        self._hold_off = int(hold_off)
        self._hold_off_remaining = min(self._hold_off_remaining,
                                       self._hold_off) if hasattr(
            self, "_hold_off_remaining") else 0

    def get_hold_off(self) -> int:
        return self._hold_off

    def set_source(self, channel: int):
        if channel >= len(self.inputs):
            raise ValueError("channel out of range")
        self._source = int(channel)

    def get_source(self) -> int:
        return self._source

    def set_event_rate(self, rate: float):
        if rate <= 0.0:
            raise ValueError("event rate must be positive")
        self._event_rate = float(rate)
        self._event_off_duration = 1.0 / rate
        self._auto_force_timeout = 1.5 / rate

    def get_event_rate(self) -> float:
        return self._event_rate

    def set_slope(self, slope: str):
        if slope == "POS":
            self._pos_slope, self._neg_slope = True, False
        elif slope == "NEG":
            self._pos_slope, self._neg_slope = False, True
        elif slope == "LEVEL":
            self._pos_slope, self._neg_slope = True, True
        else:
            raise ValueError(f"unknown slope setting {slope}")
        self._slope_str = slope

    def get_slope(self) -> str:
        return self._slope_str

    def set_mode(self, mode: str):
        if mode not in ("AUTOMATIC", "SEMIAUTOMATIC", "NORMAL", "PERIODIC",
                        "DISABLED"):
            raise ValueError(f"unknown mode setting {mode}")
        self._mode_str = mode
        self._trigger_window_timer = mode == "SEMIAUTOMATIC"
        self._trigger_timer = mode in ("AUTOMATIC", "PERIODIC")
        self._trigger_periodic = mode == "PERIODIC"
        self._trigger_search = mode in ("AUTOMATIC", "SEMIAUTOMATIC",
                                        "NORMAL")

    def get_mode(self) -> str:
        return self._mode_str

    def set_level(self, level: float):
        self._level = float(level)

    def get_level(self) -> float:
        return self._level

    def set_position(self, position: int):
        self._position = int(position)

    def get_position(self) -> int:
        return self._position

    def set_label_id(self, label_id: str):
        self._label_id = label_id

    def get_label_id(self) -> str:
        return self._label_id

    def set_ids_list(self, ids):
        self._forward_ids = set(ids)

    def activate(self):
        self._points_remaining = 0
        self._windows_remaining = 0
        self._hold_off_remaining = 0
        self._trigger_event_from_level = False
        self._trigger_event_offset = 0.0
        self._packets = [Packet(np.zeros(0, np.float32))
                         for _ in self.inputs]
        self._last_trigger_time = time.monotonic()

    def propagate_labels(self, port, labels):
        out = self.output(0)
        for lb in labels:
            if lb.id in self._forward_ids:
                out.post_message(lb)

    # -- trigger search (reference :735-771, vectorized) ------------------ #
    def _search_level(self, buf: np.ndarray, num_elems: int):
        x = np.abs(buf[: num_elems + 1]).astype(np.float64) if \
            np.iscomplexobj(buf) else buf[: num_elems + 1].astype(np.float64)
        y0 = x[self._position: num_elems]
        y1 = x[self._position + 1: num_elems + 1]
        lvl = self._level
        hit = np.zeros(len(y0), bool)
        if self._pos_slope:
            hit |= (y0 < lvl) & (y1 >= lvl)
        if self._neg_slope:
            hit |= (y0 > lvl) & (y1 <= lvl)
        idx = np.nonzero(hit)[0]
        if idx.size == 0:
            return None
        i = int(idx[0]) + self._position
        frac = (lvl - x[i]) / (x[i + 1] - x[i])
        return i + frac

    def work(self):
        out = self.output(0)
        # forward messages/packets with port index metadata (ref :480-497)
        for name, port in self.inputs.items():
            while port.has_message():
                msg = port.pop_message()
                if isinstance(msg, Packet):
                    msg.metadata["index"] = int(name)
                out.post_message(msg)

        if self._points_remaining == 0:
            return self._trigger_work()

        first_window = self._windows_remaining == self._num_windows - 1
        last_window = self._windows_remaining == 0
        win_points = self._num_points // self._num_windows

        all_acquired = True
        for name, port in self.inputs.items():
            idx = int(name)
            packet = self._packets[idx]
            acquired = packet.payload.shape[0] // win_points if win_points else 0
            if acquired + self._windows_remaining == self._num_windows:
                if not self._alignment:
                    port.consume(port.elements())
                continue
            if port.elements() < self._points_remaining:
                port.set_reserve(self._points_remaining)
                all_acquired = False
                continue
            buf = np.array(port.buffer(self._points_remaining), copy=True)
            base = packet.payload.shape[0]
            for lb in list(port.labels):
                if lb.index >= len(buf):
                    break
                packet.labels.append(lb.shifted(base))
            if self._trigger_event_from_level and idx == self._source:
                packet.labels.append(Label("T", None, self._position + base))
            if first_window:
                packet.metadata["index"] = idx
                packet.metadata["position"] = self._trigger_event_offset
                packet.metadata["level"] = self._level
            if self._alignment:
                port.consume(len(buf))
            else:
                port.consume(port.elements())
            port.set_reserve(0)
            packet.payload = buf if packet.payload.shape[0] == 0 else \
                np.concatenate([packet.payload, buf])

        if not all_acquired:
            return
        if last_window:
            for i in range(len(self.inputs)):
                self._packets[i].dtype = None
                out.post_message(self._packets[i])
            self._packets = [Packet(np.zeros(0, np.float32))
                             for _ in self.inputs]
        self._points_remaining = 0
        self._hold_off_remaining = self._hold_off
        self._last_trigger_time = time.monotonic()

    def _trigger_work(self):
        trig_port = self.input(self._source)
        time_passed = time.monotonic() - self._last_trigger_time
        search_enabled = ((self._windows_remaining > 0)
                          or (time_passed > self._event_off_duration)) and \
            self._hold_off_remaining == 0

        num_elems = trig_port.elements()
        all_ready = True
        for name, port in self.inputs.items():
            if not self._alignment and port is not trig_port:
                port.consume(port.elements())
                continue
            num_elems = min(num_elems, port.elements())
            if num_elems > self._position + 1:
                continue
            port.set_reserve(self._position + 2)
            all_ready = False
        if not all_ready:
            return

        found = False
        self._trigger_event_offset = float(self._position)
        self._trigger_event_from_level = False
        buf = np.asarray(trig_port.buffer(num_elems))
        if search_enabled and self._trigger_search:
            if self._label_id:
                for lb in sorted(trig_port.labels, key=lambda l: l.index):
                    if lb.id != self._label_id:
                        continue
                    if lb.index < self._position:
                        continue
                    if lb.index >= num_elems - 1:
                        break
                    found = True
                    self._trigger_event_offset = float(lb.index)
                    break
            else:
                pos = self._search_level(buf, num_elems - 1)
                if pos is not None:
                    found = True
                    self._trigger_event_offset = pos
                    self._trigger_event_from_level = True
            if not found and (self._trigger_timer or (
                    self._trigger_window_timer
                    and self._windows_remaining != 0)):
                found = time_passed > self._auto_force_timeout
        elif search_enabled and not self._trigger_search:
            found = self._trigger_timer

        if found:
            consume = int(self._trigger_event_offset - self._position)
            self._trigger_event_offset -= consume
        elif self._hold_off_remaining != 0:
            consume = min(num_elems, self._hold_off_remaining)
            self._hold_off_remaining -= consume
        elif self._trigger_periodic:
            consume = num_elems
        else:
            consume = num_elems - self._position - 1

        for name, port in self.inputs.items():
            if self._alignment or port is trig_port:
                port.consume(min(consume, port.elements()))

        if found:
            if self._windows_remaining == 0:
                self._windows_remaining = self._num_windows
            self._windows_remaining -= 1
            self._points_remaining = self._num_points // self._num_windows
            for port in self.inputs.values():
                port.set_reserve(0)


@register_block("/comms/combine_complex")
class CombineComplex(Block):
    """named "re"+"im" input ports -> complex (reference
    CombineComplex.cpp)."""

    def __init__(self, dtype="float32"):
        super().__init__()
        scalar = DType.parse(dtype)
        if scalar.is_complex:
            scalar = scalar.scalar
        self.dtype = DType.parse("complex_" + scalar.name)
        self.scalar = scalar
        self.setup_input("re", scalar)
        self.setup_input("im", scalar)
        self.setup_output(0, self.dtype)

    def work(self):
        re_port, im_port = self.input("re"), self.input("im")
        n = min(re_port.elements(), im_port.elements())
        if n == 0:
            return
        re = np.asarray(re_port.buffer(n))
        im = np.asarray(im_port.buffer(n))
        if self.dtype.is_complex_int:
            out = np.stack([re, im], axis=-1)
        else:
            out = (re.astype(np.float64) + 1j * im.astype(np.float64)).astype(
                self.dtype.np
            )
        re_port.consume(n)
        im_port.consume(n)
        self.output(0).post(out)

    # -- auto-fusion: fan-in HEAD stacking two f32 planes --------------- #
    def fuse_ready(self) -> bool:
        return self.scalar.is_float and self.scalar.bits == 32

    def fuse_export(self, channels: int):
        def step(carry, xs):
            import jax.numpy as jnp

            return carry, jnp.stack([xs[0], xs[1]], axis=-1)

        return (), step

    def fuse_import(self, carry) -> None:
        pass
