"""Device (planar-f32) cores for the digital symbol-coding blocks.

The reference gives every digital block an unrolled SIMD pack/unpack
loop (reference: digital/SymbolHelpers.hpp:13-414); the fused
equivalent carries uint8 streams as integer-valued float32 planes (the
fused stream layout, core/fusion.py) and expresses every conversion as
exact elementwise f32 arithmetic:

- all stream values are integers < 2^16, exactly representable in f32;
- bit extraction is ``floor(x / 2^k) mod 2`` (exact);
- packing is a sum of <= 8 distinct powers of two (exact);
- mod-2^k is ``x - 2^k * floor(x / 2^k)`` (exact).

No matmuls are used here (a reduced-precision matmul could round
8-bit operands), so precision flags are irrelevant: every op below is
exact elementwise f32 arithmetic. Cores are shape-polymorphic over [C, T] planes and
jitted by the fusion executor (core/fusion.py).
"""

from __future__ import annotations

import numpy as np


def _shifts(width: int, order: str) -> list:
    return list(range(width - 1, -1, -1)) if order == "MSBit" \
        else list(range(width))


def floor_div(x, k: float):
    import jax.numpy as jnp

    return jnp.floor(x / np.float32(k))


def mod_pow2(x, k: float):
    import jax.numpy as jnp

    return x - np.float32(k) * jnp.floor(x / np.float32(k))


def pack_core(width: int, order: str):
    """[C, T] bit plane (nonzero == 1, reference SymbolHelpers.hpp:13-41)
    -> [C, T/width] symbols."""

    def core(x):
        import jax.numpy as jnp

        C, T = x.shape
        xr = jnp.reshape(x, (C, T // width, width))
        bits = jnp.where(xr != 0, np.float32(1.0), np.float32(0.0))
        acc = None
        for j, s in enumerate(_shifts(width, order)):
            term = bits[..., j] * np.float32(1 << s)
            acc = term if acc is None else acc + term
        return acc

    return core


def unpack_core(width: int, order: str):
    """[C, T] symbols -> [C, T*width] 0/1 bits."""

    def core(x):
        import jax.numpy as jnp

        planes = [mod_pow2(floor_div(x, float(1 << s)), 2.0)
                  for s in _shifts(width, order)]
        y = jnp.stack(planes, axis=-1)  # [C, T, width]
        return jnp.reshape(y, (x.shape[0], x.shape[1] * width))

    return core


def repack_core(in_width: int, out_width: int, order: str):
    """width-A symbols -> width-B symbols through the common bitstream
    (symbols_to_bytes: B=8; bytes_to_symbols: A=8)."""
    unpack = unpack_core(in_width, order)
    pack = pack_core(out_width, order)

    def core(x):
        return pack(unpack(x))

    return core


def mapper_core(table: np.ndarray, complex_out: bool):
    """[C, T] symbol indices -> constellation points via a K-term
    one-hot sum (K <= 32 gate at the block; reference:
    digital/SymbolMapper.cpp). Index is masked mod K (K a power of 2)."""
    K = len(table)
    if complex_out:
        tre = np.real(table).astype(np.float32)
        tim = np.imag(table).astype(np.float32)
    else:
        tre = np.real(table).astype(np.float32)

    def core(x):
        import jax.numpy as jnp

        idx = mod_pow2(x, float(K))
        re = im = None
        for k in range(K):
            sel = jnp.where(idx == np.float32(k), np.float32(1.0),
                            np.float32(0.0))
            r = sel * np.float32(tre[k])
            re = r if re is None else re + r
            if complex_out:
                i = sel * np.float32(tim[k])
                im = i if im is None else im + i
        if complex_out:
            return jnp.stack([re, im], axis=-1)
        return re

    return core


def slicer_core(points: np.ndarray, complex_in: bool):
    """Nearest constellation index, earliest index winning ties
    (reference SymbolSlicer.cpp:78-100 keeps the first strict minimum).
    Earliest-argmin without integer HLOs: idx = K - max_k((K-k)·[d_k ==
    d_min])."""
    K = len(points)
    pre = np.real(points).astype(np.float32)
    pim = np.imag(points).astype(np.float32)

    def core(x):
        import jax.numpy as jnp

        if complex_in:
            xr, xi = x[..., 0], x[..., 1]
        else:
            xr, xi = x, None
        ds = []
        for k in range(K):
            dr = xr - np.float32(pre[k])
            d = dr * dr
            if xi is not None:
                di = xi - np.float32(pim[k])
                d = d + di * di
            ds.append(d)
        dmin = ds[0]
        for d in ds[1:]:
            dmin = jnp.minimum(dmin, d)
        best = None
        for k, d in enumerate(ds):
            m = jnp.where(d == dmin, np.float32(K - k), np.float32(0.0))
            best = m if best is None else jnp.maximum(best, m)
        return np.float32(K) - best

    return core


_DIFF_BLOCK = 2048


def diff_encode_core(symbols: int):
    """Blocked exact cumulative-sum-mod-N (the telescoped differential
    encoder recursion, reference digital/DifferentialEncoder.cpp):
    within-row f32 cumsums stay < 2^24, row totals are reduced mod N
    before the cross-row prefix, so every intermediate is exact."""
    N = float(symbols)

    def core(carry, x):
        import jax.numpy as jnp

        C, T = x.shape
        Lb = _DIFF_BLOCK
        B = -(-T // Lb)
        pad = B * Lb - T
        xp = jnp.pad(x, ((0, 0), (0, pad)))
        xb = xp.reshape(C, B, Lb)
        within = jnp.cumsum(xb, axis=-1)          # <= Lb * (N-1) < 2^20
        rowtot = jnp.mod(within[..., -1], N)       # < N
        rowpre = jnp.cumsum(rowtot, axis=-1) - rowtot  # exclusive, < B*N
        y = within + rowpre[..., None] + carry[:, None, None]
        y = y - N * jnp.floor(y / N)
        y = y.reshape(C, B * Lb)[:, :T]
        return y[:, -1:], y

    return core


def diff_decode_core(symbols: int):
    """out[i] = ((in[i] - in[i-1] + N) mod 2^32) mod N — the C uint32
    semantics of the reference (DifferentialDecoder.cpp:62-65). For
    well-formed streams (values < N) the wrap never fires; for
    out-of-range uint8 inputs the wrap residue R = 2^32 mod N is folded
    in exactly (2^32 itself is not f32-representable next to small v)."""
    N = float(symbols)
    R = float((1 << 32) % symbols)

    def core(carry, x):
        import jax.numpy as jnp

        prev = jnp.concatenate([carry, x[:, :-1]], axis=1)
        v = x - prev + N
        m = v - N * jnp.floor(v / N)  # floor-mod, exact for |v| < 2^24
        wrapped = m + R
        wrapped = wrapped - N * jnp.floor(wrapped / N)
        y = jnp.where(v >= 0, m, wrapped)
        return x[:, -1:], y

    return core


def bit_planes(x, bits: int):
    """[C, T] integer-valued f32 -> list of ``bits`` 0/1 planes (LSB
    first)."""
    return [mod_pow2(floor_div(x, float(1 << j)), 2.0)
            for j in range(bits)]


def from_bit_planes(planes):
    acc = None
    for j, p in enumerate(planes):
        term = p * np.float32(1 << j)
        acc = term if acc is None else acc + term
    return acc


def signed_wrap(core, bits: int, nargs: int = 1):
    """Run an unsigned bit-plane core on SIGNED streams: two's
    complement maps value v < 0 to v + 2^bits (exact in f32 for bits <=
    16), and the result maps back (y >= 2^(bits-1) -> y - 2^bits)."""
    span = np.float32(1 << bits)
    half = np.float32(1 << (bits - 1))

    def wrapped(*xs):
        import jax.numpy as jnp

        us = [jnp.where(x < 0, x + span, x) for x in xs[:nargs]]
        y = core(*us)
        return jnp.where(y >= half, y - span, y)

    return wrapped


def bitwise_not_core(bits: int):
    top = float((1 << bits) - 1)

    def core(x):
        return np.float32(top) - x

    return core


def bitwise_binary_core(op: str, bits: int):
    """Elementwise AND/OR/XOR on integer-valued f32 via bit planes:
    and = a·b, or = a+b-ab, xor = a+b-2ab per plane (exact)."""

    def core(a, b):
        pa = bit_planes(a, bits)
        pb = bit_planes(b, bits)
        out = []
        for x, y in zip(pa, pb):
            if op == "AND":
                out.append(x * y)
            elif op == "OR":
                out.append(x + y - x * y)
            else:  # XOR
                out.append(x + y - 2.0 * x * y)
        return from_bit_planes(out)

    return core


def bitshift_core(left: bool, shift: int, bits: int):
    def core(x):
        if left:
            return mod_pow2(x * np.float32(1 << shift), float(1 << bits))
        return floor_div(x, float(1 << shift))

    return core


def byteswap16_core():
    """uint16 endian swap: (x mod 256)*256 + floor(x/256) (exact)."""

    def core(x):
        return mod_pow2(x, 256.0) * np.float32(256.0) + floor_div(x, 256.0)

    return core
