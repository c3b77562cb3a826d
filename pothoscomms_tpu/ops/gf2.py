"""GF(2) affine state-space operators for LFSR scrambling as matmuls.

The reference's scrambler/descrambler/keystream loops are bit-serial
recursions over a Galois LFSR (reference: digital/lfsr.h:64-100,
digital/Scrambler.cpp, digital/Descrambler.cpp). Every mode of that
loop — additive keystream, multiplicative scrambler (output feedback),
multiplicative descrambler (input-driven, self-synchronizing) — is an
AFFINE map over GF(2):

    s[i+1] = (A s[i] + b x[i]) mod 2        state: 64 bits
    o[i]   = (w . s[i] + x[i]) mod 2        output bit

so an L-sample block telescopes into exact linear algebra, the same
trade as the blocked state-space IIR (ops/filter.py): per block of Lb
samples,

    o_blk = (V s_k + L x_blk) mod 2         V: [Lb, 64], L: [Lb, Lb]
    s_{k+1} = (A^Lb s_k + G x_blk) mod 2    G: [64, Lb]

with the block recurrence solved by one ``lax.associative_scan`` over
constant-matrix affine pairs. All matrices are 0/1 valued, so f32
matmuls are EXACT (products of 0/1 are exact in bf16, sums <= Lb <<
2^24 accumulate exactly in the f32 matmul accumulators); a final
``x - 2*floor(x/2)`` reduces mod 2.

Rather than hand-deriving (A, b, w) per mode — an error-prone
transcription of the Galois step's shift/conditional-xor/bit-splice —
they are PROBED from the streaming implementation itself: run the
scalar LFSR step on each basis state and on the unit input, read off
the columns. The derived system is therefore bit-exact with the
streaming path by construction (verified: tests/test_gf2.py).
"""

from __future__ import annotations

import functools

import numpy as np

NBITS = 64


def _state_bits(v: int) -> np.ndarray:
    return np.array([(v >> i) & 1 for i in range(NBITS)], np.uint8)


def _bits_state(bits) -> int:
    return int(sum(int(b) << i for i, b in enumerate(bits)))


def _one_step(poly: int, mode: str, state: int, x: int):
    """One scalar step of the streaming implementation (the contract)."""
    from pothoscomms_tpu.blocks.digital import GaloisLFSR

    l = GaloisLFSR(poly, state)
    if mode == "additive":
        k = l.next()
        out = (x ^ k) & 1
        return l.data, out
    if mode == "scramble":
        out = int(l.scramble_mult(np.array([x], np.uint8))[0])
        return l.data, out
    if mode == "descramble":
        out = int(l.descramble_mult(np.array([x], np.uint8))[0])
        return l.data, out
    raise ValueError(mode)


@functools.lru_cache(maxsize=32)
def lfsr_affine_maps(poly: int, mode: str):
    """Probe the scalar LFSR step into (A [64,64], b [64], w [64]) over
    GF(2) with s' = A s + b x, o = w s + x (the affine constant is zero:
    the zero state with zero input maps to zero for every mode)."""
    s0, o0 = _one_step(poly, mode, 0, 0)
    assert s0 == 0 and o0 == 0, "LFSR step has a nonzero affine constant"
    A = np.zeros((NBITS, NBITS), np.uint8)
    w = np.zeros(NBITS, np.uint8)
    for i in range(NBITS):
        s_next, out = _one_step(poly, mode, 1 << i, 0)
        A[:, i] = _state_bits(s_next)
        w[i] = out
    s_next, out = _one_step(poly, mode, 0, 1)
    b = _state_bits(s_next)
    assert out == 1, "output must carry the input bit directly"
    # verify affinity on a few random (state, input) pairs
    rng = np.random.default_rng(0xC0)
    for _ in range(8):
        s = int(rng.integers(0, 1 << 63))
        x = int(rng.integers(0, 2))
        s_ref, o_ref = _one_step(poly, mode, s, x)
        sb = _state_bits(s)
        s_lin = (A @ sb + b * x) % 2
        o_lin = (int(w @ sb) + x) % 2
        assert _bits_state(s_lin) == s_ref and o_lin == o_ref, \
            "LFSR step is not affine over GF(2) (mode contract broken)"
    return A, b, w


@functools.lru_cache(maxsize=32)
def lfsr_blocked_operators(poly: int, mode: str, block: int):
    """Host-side (exact uint8 mod-2) block operators for an Lb=``block``
    sample step. Returns (V, Lst, G, Ab, autonomous):

    - V   [Lb, 64]  o contribution of the block-start state: w A^l
    - Lst [Lb, Lb]  strictly-lower Toeplitz input convolution
                    Lst[i, j] = w A^(i-1-j) b  (i > j)
    - G   [64, Lb]  state drive: s' += A^(Lb-1-j) b x_j
    - Ab  [64, 64]  A^Lb
    - autonomous    True when b == 0 (additive keystream: Lst = G = 0)
    """
    A, b, w = lfsr_affine_maps(poly, mode)
    Lb = int(block)
    V = np.zeros((Lb, NBITS), np.uint8)
    h = np.zeros(Lb, np.uint8)  # h[d] = w A^(d-1) b for d >= 1
    G = np.zeros((NBITS, Lb), np.uint8)
    row = w.copy()          # w A^l
    col = b.copy()          # A^d b
    V[0] = row
    for l in range(1, Lb):
        row = (row @ A) % 2
        V[l] = row
        h[l] = int(w @ col) % 2
        col = (A @ col) % 2
    # col now = A^(Lb-1) b; walk back for G columns
    colj = b.copy()
    for j in range(Lb - 1, -1, -1):
        G[:, j] = colj
        if j:
            colj = (A @ colj) % 2
    Ab = np.eye(NBITS, dtype=np.uint8)
    Apow = A.copy()
    e = Lb
    while e:
        if e & 1:
            Ab = (Ab @ Apow) % 2
        Apow = (Apow @ Apow) % 2
        e >>= 1
    autonomous = not b.any()
    if autonomous:
        Lst = np.zeros((Lb, Lb), np.uint8)
        G = np.zeros((NBITS, Lb), np.uint8)
    else:
        i, j = np.indices((Lb, Lb))
        d = i - j
        Lst = np.where(d > 0, h[np.clip(d, 0, Lb - 1)], 0).astype(np.uint8)
    return V, Lst, G, Ab, autonomous


def export_state(value: int):
    """LFSR integer state -> [64] f32 bit plane (device carry)."""
    return _state_bits(value).astype(np.float32)


def import_state(bits) -> int:
    b = np.rint(np.asarray(bits)).astype(np.int64) & 1
    return _bits_state(b)


def lfsr_blocked_step(s, x, V, Lst, G, Ab, autonomous: bool):
    """One fused quantum: x [C, T] 0/1 f32 (T % Lb == 0), s [C, 64]
    f32 bit planes -> (s', o [C, T]). Pure jnp; jit by the caller."""
    import jax.numpy as jnp
    from jax import lax

    C, T = x.shape
    Lb = V.shape[0]
    B = T // Lb
    xb = x.reshape(C, B, Lb)

    def mod2(v):
        return v - 2.0 * jnp.floor(v * 0.5)

    if autonomous:
        q = jnp.zeros((B, C, NBITS), jnp.float32)
    else:
        q = mod2(jnp.einsum("cbl,kl->bck", xb, G))
    # affine pairs (M_j = Ab, v_j = q_j); scanned[j]: s0 -> s_{j+1}.
    # Scan axis 0 on every leaf (associative_scan applies ONE axis to
    # the whole tree), so v carries [B, C, 64].
    M0 = jnp.broadcast_to(Ab, (B, NBITS, NBITS))

    def combine(p1, p2):
        M1, v1 = p1
        M2, v2 = p2
        return (mod2(jnp.einsum("bij,bjk->bik", M2, M1)),
                mod2(jnp.einsum("bij,bcj->bci", M2, v1) + v2))

    Ms, vs = lax.associative_scan(combine, (M0, q), axis=0)
    # starting state of block j: j == 0 -> s0; else Ms[j-1] s0 + vs[j-1]
    s_all = mod2(jnp.einsum("bij,cj->bci", Ms, s)
                 + vs).transpose(1, 0, 2)  # [C, B, 64]: s_1..s_B
    s_start = jnp.concatenate([s[:, None, :], s_all[:, :-1, :]], axis=1)
    o = jnp.einsum("cbj,lj->cbl", s_start, V) + xb
    if not autonomous:
        o = o + jnp.einsum("cbl,ml->cbm", xb, Lst)
    o = mod2(o)
    return s_all[:, -1, :], o.reshape(C, T)
