"""Mesh sharding for multi-device scale-out.

The reference has no distribution layer (SURVEY.md §2.13(4): Pothos remote
proxy only); this module is the equivalent mandated by BASELINE.md's
north star: shard [channel, time] streams over a ``jax.sharding.Mesh``,
with XLA collectives riding NVLink between the cards of a host (all to
all, so the mesh shape follows the algorithm only).

Two shardings are provided:

- **Channel sharding** ("ch" axis): embarrassingly parallel — each device
  owns C/n channels end to end. No collectives in steady state. This is
  the default for the multichannel configs.
- **Time sharding** ("t" axis): each device owns a time slice; stateful
  kernels (FIR history) exchange K-1-sample halos with ``ppermute`` to the
  right neighbor — the overlap-save boundary exchange.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from pothoscomms_tpu.parallel.chain import fir_fft_step, complex_fir_kernel


def make_mesh(n_devices: Optional[int] = None, axis: str = "ch") -> Mesh:
    devs = jax.devices()[: n_devices or len(jax.devices())]
    return Mesh(np.asarray(devs), (axis,))


def channel_sharded_fir_fft(mesh: Mesh, taps, nbins: int, decim: int = 1):
    """FIR+FFT chain sharded over channels: [C, T, 2] with C split on the
    mesh. Returns (jitted fn, init_history fn).

    decim == 1 runs the combined FIR*DFT operator per shard (the fast
    production formulation, parallel/chain.py) with the G matrices
    replicated; rational rates use the conv path."""
    taps = np.asarray(taps)
    k = len(taps)
    # prev_pad <= nbins required by the combined step's previous-window
    # slice (see fir_fft_chain); longer taps use the conv fallback
    prev_pad = min(128, nbins)

    if decim == 1 and 1 < k <= prev_pad + 1:
        from pothoscomms_tpu.parallel.chain import (
            combined_fir_fft_operators,
            fir_fft_combined_step,
        )

        (g0r, g0i), (g1r, g1i) = combined_fir_fft_operators(
            taps, nbins, prev_pad)
        g0s = g0r + g0i
        g1s = g1r + g1i

        @jax.jit
        @partial(
            shard_map,
            mesh=mesh,
            in_specs=(P("ch"), P("ch"), P(), P(), P(), P(), P(), P()),
            out_specs=(P("ch"), P("ch")),
        )
        def run(x, hist, a, b, c, d, e, f):
            return fir_fft_combined_step(x, hist, a, b, c, d, e, f,
                                         nbins, k, prev_pad)

        def init_history(channels: int):
            return jnp.zeros((channels, k - 1, 2), jnp.float32)

        return (lambda x, h: run(x, h, g0r, g0i, g0s, g1r, g1i, g1s),
                init_history)

    kernel = complex_fir_kernel(taps)

    @jax.jit
    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("ch"), P("ch"), P()),
        out_specs=(P("ch"), P("ch")),
    )
    def run(x, hist, kern):
        return fir_fft_step(x, hist, kern, nbins, decim)

    def init_history(channels: int):
        return jnp.zeros((channels, k - 1, 2), jnp.float32)

    return lambda x, h: run(x, h, kernel), init_history


def grid_sharded_fir(mesh: Mesh, taps, decim: int = 1):
    """FIR sharded over a 2-D [ch, t] mesh: channels split over "ch"
    (no collectives), time split over "t" with K-1 halos via ppermute.

    The mesh should be built with parallel.distributed.make_2d_mesh so
    the "t" ring stays within one host (halos ride NVLink, not the
    network). Returns
    f(x, carry) -> (y, new_carry); carry is the stream tail [C, K-1, 2]
    replicated over the mesh.
    """
    kernel = complex_fir_kernel(np.asarray(taps))
    k = kernel.shape[-1]
    nt = mesh.shape["t"]

    @jax.jit
    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("ch", "t"), P("ch"), P()),
        out_specs=(P("ch", "t"), P("ch")),
    )
    def run(x, carry, kern):
        idx = jax.lax.axis_index("t")
        tail = x[:, x.shape[1] - (k - 1):, :] if k > 1 else x[:, :0, :]
        perm = [(i, (i + 1) % nt) for i in range(nt)]
        left_tail = jax.lax.ppermute(tail, "t", perm)
        hist = jnp.where(idx == 0, carry, left_tail) if k > 1 else left_tail
        from pothoscomms_tpu.parallel.chain import fir_multichannel
        y, _ = fir_multichannel(x, hist, kern, decim)
        contrib = jnp.where(idx == nt - 1, tail, jnp.zeros_like(tail))
        last_tail = jax.lax.psum(contrib, "t")
        return y, last_tail

    return lambda x, c: run(x, c, kernel)


def time_sharded_resampler(mesh: Mesh, taps, M: int, L: int):
    """Rational L/M polyphase resampler sharded over the time axis.

    Each device holds [C, T/n, 2]; K-1 input halos travel to the right
    neighbor via ppermute (overlap-save) and the polyphase phase
    alignment holds because each local slice length is a multiple of M
    (asserted). Output is [C, (T/n)*L/M, 2] per device, i.e. the global
    resampled stream time-sharded on the same mesh axis. The stream
    carry is the global input tail [C, K-1, 2] (fed to device 0).
    """
    from pothoscomms_tpu.ops.filter import _polyphase_matrix, polyphase_fir

    taps = np.asarray(taps, np.complex128)
    phases, K = _polyphase_matrix(taps, L)
    taps_q = jnp.asarray(
        np.stack([phases.real, phases.imag], -1).astype(np.float32))
    n = mesh.devices.size

    @jax.jit
    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(None, "t"), P(), P()),
        out_specs=(P(None, "t"), P()),
    )
    def run(x, carry, tq):
        # x: local [C, Tl, 2]; carry: replicated [C, K-1, 2]
        idx = jax.lax.axis_index("t")
        tl = x.shape[1]
        tail = x[:, tl - (K - 1):, :] if K > 1 else x[:, :0, :]
        perm = [(i, (i + 1) % n) for i in range(n)]
        left_tail = jax.lax.ppermute(tail, "t", perm)
        hist = jnp.where(idx == 0, carry, left_tail) if K > 1 else left_tail
        xh = jnp.concatenate([hist, x], axis=1)      # [C, K-1+Tl, 2]
        y = jax.vmap(
            lambda s: polyphase_fir(s, tq, M, L, K, "planar", 0))(xh)
        contrib = jnp.where(idx == n - 1, tail, jnp.zeros_like(tail))
        last_tail = jax.lax.psum(contrib, "t")
        return y, last_tail

    def runner(x, carry):
        tl = x.shape[1] // n
        if tl % M:
            raise ValueError(
                f"local slice length {tl} must be a multiple of M={M} "
                "for phase alignment across shards")
        return run(x, carry, taps_q)

    return runner


def time_sharded_fir(mesh: Mesh, taps, decim: int = 1):
    """FIR sharded over the time axis with ppermute halo exchange.

    Each device holds a contiguous [C, T/n, 2] slice. The K-1 trailing
    samples of device i are the history of device i+1 (overlap-save);
    device 0 consumes the stream-level carry. Returns the jitted fn
    f(x, carry) -> (y, new_carry) where carry is the global stream tail
    [C, K-1, 2] (fed to device 0, produced from the last device).
    """
    kernel = complex_fir_kernel(np.asarray(taps))
    k = kernel.shape[-1]
    n = mesh.devices.size

    @jax.jit
    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(None, "t"), P(), P()),
        out_specs=(P(None, "t"), P()),
    )
    def run(x, carry, kern):
        # x: local [C, T/n, 2]; carry: replicated [C, K-1, 2]
        idx = jax.lax.axis_index("t")
        tail = x[:, x.shape[1] - (k - 1):, :] if k > 1 else x[:, :0, :]
        # right-shift the tails along the ring: device i receives the
        # tail of device i-1 as its local history
        perm = [(i, (i + 1) % n) for i in range(n)]
        left_tail = jax.lax.ppermute(tail, "t", perm)
        hist = jnp.where(idx == 0, carry, left_tail) if k > 1 else left_tail
        from pothoscomms_tpu.parallel.chain import fir_multichannel
        y, _ = fir_multichannel(x, hist, kern, decim)
        # new stream carry = tail of the LAST device; psum of a one-hot
        # contribution is replication the partitioner can verify
        contrib = jnp.where(idx == n - 1, tail, jnp.zeros_like(tail))
        last_tail = jax.lax.psum(contrib, "t")
        return y, last_tail

    return lambda x, c: run(x, c, kernel)
