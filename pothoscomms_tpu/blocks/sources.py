"""Waveform and noise sources (reference: waveform/ module, SURVEY.md §2.8).

Notes: both sources are table-driven exactly like the reference
(waveform/WaveformSource.cpp:98-108 walks a power-of-2 lookup table by an
integer step+mask; waveform/NoiseSource.cpp:105-130 re-enters a pre-filled
pool at a random offset). Table *construction* is control-plane (numpy at
reconfiguration time); per-work sample generation is a vectorized gather.
Under the fused-chain compiler the same tables are closed over by the jitted
chain so generation happens on-device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from pothoscomms_tpu.core.block import Block
from pothoscomms_tpu.core.dtypes import DType
from pothoscomms_tpu.core.registry import register_block

# Tile width for device-side index generation. Index arithmetic stays
# float32-exact in the planar-f32 fused layout: all index values are
# kept < 3 * table_size <= 3 * 2^20, far inside f32's 2^24
# exact-integer range, by working per-tile with trace-time numpy
# constants for the tile offsets.
_SRC_TILE = 65536

DEFAULT_WAVE_TABLE_SIZE = 4096
MAX_WAVE_TABLE_SIZE = 1024 * 1024
MINIMUM_TABLE_STEP_SIZE = 16

# samples produced per work() call when quota allows (the analog of the
# reference's output-buffer-manager slab size). 16 Ki: profiling the
# streaming FIR topology shows per-work host->device conversion
# dominating, so fewer/larger slabs lift every downstream block; steady-
# state window shapes still stabilize to one jit trace per block.
_CHUNK = 16384


def _llround(x: float) -> int:
    """C++ llround: round half away from zero."""
    return int(np.floor(x + 0.5)) if x >= 0 else int(np.ceil(x - 0.5))


class _TableSource(Block):
    """Shared machinery: dtype-aware element conversion + chunked output."""

    def __init__(self, dtype):
        super().__init__()
        self.dtype = DType.parse(dtype)
        if self.dtype.kind == "uint":
            raise ValueError("unsupported type (reference factory matrix is "
                             "int/float only)")
        self.setup_output(0, self.dtype)
        self.unbounded_source = True
        self._offset = complex(0.0)
        self._scalar = complex(1.0)

    # reference setElem (waveform/WaveformSource.cpp:249-259): real dtypes
    # keep the real part; integer casts truncate toward zero like C.
    def _convert(self, vals: np.ndarray) -> np.ndarray:
        vals = self._scalar * np.asarray(vals, np.complex128) + self._offset
        dt = self.dtype
        if dt.is_complex:
            if dt.is_float:
                return vals.astype(dt.np)
            return np.stack(
                [np.trunc(vals.real), np.trunc(vals.imag)], axis=-1
            ).astype(dt.scalar.np)
        if dt.is_float:
            return vals.real.astype(dt.np)
        return np.trunc(vals.real).astype(dt.np)

    def set_offset(self, offset):
        self._offset = complex(offset)
        self._update_table()

    def get_offset(self):
        return self._offset

    def set_amplitude(self, scalar):
        self._scalar = complex(scalar)
        self._update_table()

    def get_amplitude(self):
        return self._scalar

    def _update_table(self):  # override
        pass

    def activate(self):
        self._update_table()


@register_block("/comms/waveform_source", "/blocks/waveform_source")
class WaveformSource(_TableSource):
    """CONST/SINE/RAMP/SQUARE cyclic source
    (reference: waveform/WaveformSource.cpp).

    Complex output is quadrature: im lags re by 90 degrees (table built from
    one complex rotation; RAMP/SQUARE use the i+(3N/4) mod N trick,
    WaveformSource.cpp:228,239).
    """

    DOC = {
        "category": "/Sources",
        "keywords": ["waveform", "source", "signal", "sine", "ramp"],
        "params": {
            "waveform": {
                "label": "Wave Type",
                "options": [{"label": w.title(), "value": w} for w in
                            ("CONST", "SINE", "RAMP", "SQUARE")],
                "default": "CONST",
            },
            "frequency": {"label": "Frequency", "units": "Hz",
                          "default": 0.0},
            "sample_rate": {"label": "Sample Rate", "units": "Sps",
                            "default": 1.0},
            "resolution": {"label": "Resolution", "units": "Hz",
                           "default": 0.0,
                           "desc": "Frequency resolution for table "
                                   "auto-sizing (0 = from frequency)."},
            "amplitude": {"label": "Amplitude", "default": [1.0, 0.0]},
            "offset": {"label": "Offset", "default": [0.0, 0.0]},
        },
    }

    def __init__(self, dtype="complex_float32"):
        super().__init__(dtype)
        self._index = 0
        self._step = 0
        self._mask = 0
        self._rate = 1.0
        self._freq = 0.0
        self._res = 0.0
        self._wave = "CONST"
        self._table: Optional[np.ndarray] = None

    # -- setters (reference :110-174) ---------------------------------- #
    def set_waveform(self, wave: str):
        self._wave = wave
        self._update_table()

    def get_waveform(self) -> str:
        return self._wave

    def set_frequency(self, freq: float):
        self._freq = float(freq)
        self._update_table()

    def get_frequency(self) -> float:
        return self._freq

    def set_sample_rate(self, rate: float):
        self._rate = float(rate)
        self._update_table()

    def get_sample_rate(self) -> float:
        return self._rate

    def set_resolution(self, res: float):
        self._res = float(res)
        self._update_table()

    def get_resolution(self) -> float:
        return self._res

    # -- table construction (reference :178-247) ------------------------ #
    def _update_table(self):
        if not self.is_active():
            return
        frac = (self._freq if self._res == 0.0 else self._res) / self._rate
        num_entries = DEFAULT_WAVE_TABLE_SIZE
        while True:
            delta = _llround(frac * num_entries)
            if frac == 0.0:
                break
            if abs(delta) >= MINIMUM_TABLE_STEP_SIZE:
                break
            if num_entries * 2 > MAX_WAVE_TABLE_SIZE:
                break
            num_entries *= 2

        self._mask = num_entries - 1
        self._step = _llround((self._freq / self._rate) * num_entries)
        if self._step == 0 and self._freq != 0.0:
            raise ValueError(
                "WaveformSource.update_table: step size not achievable"
            )

        n = num_entries
        i = np.arange(n)
        if self._wave == "CONST":
            vals = np.ones(n, np.complex128)
        elif self._wave == "SINE":
            vals = np.exp(2j * np.pi * i / n)
        elif self._wave == "RAMP":
            q = (i + (3 * n) // 4) % n
            vals = (2.0 * i / (n - 1) - 1.0) + 1j * (2.0 * q / (n - 1) - 1.0)
        elif self._wave == "SQUARE":
            q = (i + (3 * n) // 4) % n
            vals = np.where(i < n // 2, 0.0, 1.0) + 1j * np.where(
                q < n // 2, 0.0, 1.0
            )
        else:
            raise ValueError(f"unknown waveform setting {self._wave!r}")
        self._table = self._convert(vals)
        self._bump_fuse_epoch()

    # -- generation (reference :98-108, vectorized) ---------------------- #
    def work(self):
        if self._table is None:
            self._update_table()
        n = min(self._source_quota, _CHUNK) if self._source_quota else _CHUNK
        if n <= 0:
            return
        size = self._mask + 1
        idx = (self._index + np.arange(n) * self._step) % size
        self.output(0).post(self._table[idx])
        self._index = (self._index + n * self._step) % size
        self._source_quota = max(0, self._source_quota - n)

    # -- auto-fusion source protocol (core/fusion.py) -------------------- #
    # A source-headed fused segment generates samples ON DEVICE (table
    # gather) so a source -> chain topology runs device-resident end to
    # end with zero H2D staging per quantum — the analog of the
    # reference's sources feeding the scheduler at memory speed
    # (waveform/WaveformSource.cpp:98-108).
    def fuse_source_ready(self) -> bool:
        if not (self.dtype.is_float and self.dtype.bits == 32):
            return False
        if self._table is None and self.is_active():
            self._update_table()
        return self._table is not None

    def fuse_source_export(self, channels: int):
        """-> (carry, src_step, params). ``src_step(carry, t, *params)``
        produces [1, t(, 2)] planar f32; ``t`` is static per trace.

        The step+mask table walk visits tbl[(index + j*step) mod N] —
        periodic with period N/gcd(step, N). The whole period is
        materialized ON THE HOST at engage (exact int64 index math),
        starting from the CURRENT index, so device generation becomes a
        CONSECUTIVE walk over that sequence: per tile, one contiguous
        dynamic-slice of the extended sequence. (A scalar per-sample
        gather lowers on this backend with a ~x128 lane-padded temp —
        ~512 B/sample of HBM — which OOMs whole-chain programs at 16 Mi
        quanta; sliced gathers don't.) Carry = samples emitted mod
        period (f32-exact: period <= 2^20)."""
        import jax
        import jax.numpy as jnp

        if self._table is None:
            self._update_table()
        N = self._mask + 1
        step_i = self._step % N
        import math as _math

        period = N // _math.gcd(step_i, N) if step_i else 1
        idxs = (self._index
                + np.arange(period, dtype=np.int64) * step_i) % N
        s = self._table[idxs]
        TILE = _SRC_TILE
        reps = 1 + -(-TILE // period)
        s_ext = np.concatenate([s] * reps)[: period + TILE]
        if self.dtype.is_complex:
            se = jnp.asarray(
                np.stack([s_ext.real, s_ext.imag], -1).astype(np.float32))
        else:
            se = jnp.asarray(s_ext.astype(np.float32))
        carry = jnp.asarray(np.float32(0.0))
        fper = float(period)

        def src_step(carry, t, se):
            k = -(-t // TILE)
            offs_c = jnp.asarray(
                (np.arange(k, dtype=np.int64) * TILE % period
                 ).astype(np.float32))
            offs = jnp.mod(offs_c + carry, fper).astype(jnp.int32)
            y = jax.vmap(
                lambda o: jax.lax.dynamic_slice_in_dim(se, o, TILE, axis=0)
            )(offs)
            y = y.reshape((k * TILE,) + se.shape[1:])[:t]
            adv = np.float32(t % period)
            return jnp.mod(carry + adv, fper), y[None]

        # close over period/step for the exact import mapping
        self._fuse_walk = (step_i, period, self._index)
        return carry, src_step, (se,)

    def fuse_source_import(self, carry) -> None:
        step_i, period, index0 = getattr(
            self, "_fuse_walk", (self._step % (self._mask + 1), 1,
                                 self._index))
        j = int(round(float(np.asarray(carry)))) % max(period, 1)
        # t_total = j (mod period) and period*step = 0 (mod N), so the
        # raw index advance j*step is exact
        self._index = (index0 + j * step_i) % (self._mask + 1)


@register_block("/comms/noise_source", "/blocks/noise_source")
class NoiseSource(_TableSource):
    """UNIFORM/NORMAL/LAPLACE/POISSON noise source
    (reference: waveform/NoiseSource.cpp).

    Fast mode pre-fills a 4096-entry pool and re-enters it at a random
    offset each work() (reference :105-117); slow mode draws fresh samples
    every element (:119-128). Seedable for reproducible tests (the
    reference uses std::random_device; we default-seed from it too but
    accept a seed).
    """

    DOC = {
        "category": "/Sources",
        "keywords": ["noise", "random", "source", "gaussian"],
        "params": {
            "waveform": {
                "label": "Wave Type",
                "options": [{"label": w.title(), "value": w} for w in
                            ("UNIFORM", "NORMAL", "LAPLACE", "POISSON")],
                "default": "NORMAL",
            },
            "mean": {"label": "Mean", "default": 0.0},
            "b": {"label": "B", "default": 1.0,
                  "desc": "Distribution spread parameter (stddev / "
                          "half-width / scale)."},
            "fast": {"label": "Fast Mode", "default": True,
                     "widget": "ToggleSwitch",
                     "desc": "Pre-filled pool re-entered at a random "
                             "offset per work call."},
        },
    }

    def __init__(self, dtype="complex_float32", seed: Optional[int] = None):
        super().__init__(dtype)
        self._wave = "NORMAL"
        self._mean = 0.0
        self._b = 1.0
        self._fast = True
        self._index = 0
        self._rng = np.random.default_rng(seed)
        self._table: Optional[np.ndarray] = None

    # -- setters (reference :132-185) ------------------------------------ #
    def set_waveform(self, wave: str):
        if wave not in ("UNIFORM", "NORMAL", "LAPLACE", "POISSON"):
            raise ValueError(f"unknown waveform setting {wave!r}")
        self._wave = wave
        self._update_table()

    def get_waveform(self) -> str:
        return self._wave

    def set_mean(self, mean: float):
        self._mean = float(mean)
        self._update_table()

    def get_mean(self) -> float:
        return self._mean

    def set_b(self, b: float):
        self._b = float(b)
        self._update_table()

    def get_b(self) -> float:
        return self._b

    def set_fast(self, fast: bool):
        self._fast = bool(fast)
        self._bump_fuse_epoch()

    # -- draws ----------------------------------------------------------- #
    def _draw(self, n: int) -> np.ndarray:
        """n complex draws with independent re/im components."""
        m, b = self._mean, self._b
        if self._wave == "UNIFORM":
            re, im = (self._rng.uniform(m - b, m + b, n) for _ in range(2))
        elif self._wave == "NORMAL":
            re, im = (self._rng.normal(m, b, n) for _ in range(2))
        elif self._wave == "LAPLACE":
            # reference quirk preserved: Laplace synthesized from a
            # uniform(mean-b, mean+b) draw (NoiseSource.cpp:243-249)
            def lap():
                u = self._rng.uniform(m - b, m + b, n)
                return np.where(u < 0, m + b * np.log1p(u), m - b * np.log1p(-u))

            re, im = lap(), lap()
        elif self._wave == "POISSON":
            re, im = (
                self._rng.poisson(max(m, 0.0), n).astype(np.float64)
                for _ in range(2)
            )
        else:
            raise ValueError(f"unknown waveform setting {self._wave!r}")
        return re + 1j * im

    def _update_table(self):
        if not self.is_active():
            return
        self._table = self._convert(self._draw(DEFAULT_WAVE_TABLE_SIZE))
        self._bump_fuse_epoch()

    def work(self):
        if self._table is None:
            self._update_table()
        n = min(self._source_quota, _CHUNK) if self._source_quota else _CHUNK
        if n <= 0:
            return
        if self._fast:
            self._index += int(self._rng.integers(0, DEFAULT_WAVE_TABLE_SIZE))
            idx = (self._index + np.arange(n)) % DEFAULT_WAVE_TABLE_SIZE
            out = self._table[idx]
            self._index += n
        else:
            out = self._convert(self._draw(n))
        self.output(0).post(out)
        self._source_quota = max(0, self._source_quota - n)

    # -- auto-fusion source protocol (core/fusion.py) -------------------- #
    # Fast mode only: the device core re-enters the pre-filled pool at a
    # Weyl-sequence offset per 4096-tile (the host path re-enters at a
    # numpy-RNG offset per work call, NoiseSource.cpp:105-117 — fast
    # mode has no deterministic sequence contract, so parity with the
    # streaming path is statistical, not bit-exact).
    def fuse_source_ready(self) -> bool:
        if not (self.dtype.is_float and self.dtype.bits == 32
                and self._fast):
            return False
        if self._table is None and self.is_active():
            self._update_table()
        return self._table is not None

    def fuse_source_export(self, channels: int):
        import jax
        import jax.numpy as jnp

        if self._table is None:
            self._update_table()
        P = DEFAULT_WAVE_TABLE_SIZE
        tab = self._table
        if self.dtype.is_complex:
            tbl = jnp.asarray(
                np.stack([tab.real, tab.imag], -1).astype(np.float32))
        else:
            tbl = jnp.asarray(np.asarray(tab, np.float32))
        # doubled table: each tile is then ONE contiguous P-slice at its
        # offset, so the generation lowers to k sliced gathers instead
        # of t scalar gathers
        tbl2 = jnp.concatenate([tbl, tbl], axis=0)
        carry = jnp.asarray(np.float32(int(self._rng.integers(0, P))))
        fP = float(P)
        WEYL = 2531  # odd stride ~ P/phi: low-discrepancy pool re-entry

        def src_step(carry, t, tbl2):
            k = -(-t // P)
            woffs = jnp.asarray(
                (np.arange(k, dtype=np.int64) * WEYL % P).astype(np.float32))
            offs = jnp.mod(woffs + carry, fP).astype(jnp.int32)
            y = jax.vmap(
                lambda o: jax.lax.dynamic_slice_in_dim(tbl2, o, P, axis=0)
            )(offs)                                  # [k, P(, 2)]
            y = y.reshape((k * P,) + tbl.shape[1:])[:t]
            adv = np.float32((k * WEYL) % P)
            return jnp.mod(carry + adv, fP), y[None]

        return carry, src_step, (tbl2,)

    def fuse_source_import(self, carry) -> None:
        # pool re-entry is randomized either way; nothing to restore
        pass
