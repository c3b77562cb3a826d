"""Fused-chain compiler: a linear chain of blocks -> ONE jitted program.

The streaming executor (core/topology.py) is the semantics path: every
block's work() runs separately with host-side buffers between them. For
high-rate multichannel processing that is the wrong granularity —
the whole chain should be a single XLA program over a
``[channels, time]`` block with explicit carry, so everything fuses and
nothing bounces through HBM/host between stages (SURVEY.md §2.13(1):
this replaces the reference's pipeline-across-actor-threads model).

A block opts in by implementing ``device_core(channels)`` returning
``(carry0, step)`` with ``step(carry, x) -> (carry', y)`` pure jnp over
planar float32 arrays:

- real streams:   x is [C, T] float32
- complex streams: x is [C, T, 2] planar float32

:func:`compile_chain` composes the cores front to back and jits the
result. Carries are pytrees (tuple per block).

Device cores are planar float32; the streaming blocks keep full dtype
fidelity (ROADMAP §3.4 reopens the layout).
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import jax
import jax.numpy as jnp


def compile_chain(blocks: Sequence[Any], channels: int):
    """Compose ``device_core``s of a block chain into one jitted step.

    Returns (step, carry0): ``step(x, carry) -> (y, carry')``.
    Raises TypeError for blocks that don't provide a device core.
    """
    cores = []
    carries = []
    for blk in blocks:
        fn = getattr(blk, "device_core", None)
        if fn is None:
            raise TypeError(
                f"{type(blk).__name__} has no device_core; it cannot be "
                "fused (run it in the streaming executor instead)"
            )
        carry0, step = fn(channels)
        cores.append(step)
        carries.append(carry0)

    @jax.jit
    def chain_step(x, carry):
        new_carries = []
        for step, c in zip(cores, carry):
            c2, x = step(c, x)
            new_carries.append(c2)
        return x, tuple(new_carries)

    return chain_step, tuple(carries)


def compile_chain_sharded(blocks: Sequence[Any], channels: int, mesh,
                          axis: str = "ch"):
    """compile_chain with the [C, T(, 2)] block channel-sharded over a
    ``jax.sharding.Mesh`` axis (BASELINE config #4: "256 channels
    sharded").

    Uses GSPMD propagation rather than shard_map: the input carries a
    NamedSharding constraint and XLA partitions every stage (elementwise
    ops, scans with [.., C, ..] carries, matmuls) across the mesh —
    channel parallelism needs no collectives, so the partitioner splits
    cleanly. Carries are returned unchanged (host/default placement):
    the partitioner lays them out from the input constraint on first
    call, so channel-major carry leaves end up split and scalars
    replicated without explicit device_puts.

    Returns (step, carry0) like compile_chain.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    step, carry0 = compile_chain(blocks, channels)
    x_sharding = NamedSharding(mesh, P(axis))

    @jax.jit
    def sharded_step(x, carry):
        x = jax.lax.with_sharding_constraint(x, x_sharding)
        return step(x, carry)

    return sharded_step, carry0


def run_chain_numpy(step, carry, x_np: np.ndarray):
    """Convenience host wrapper: numpy (complex ok) in/out."""
    from pothoscomms_tpu.parallel import cplx

    if np.iscomplexobj(x_np):
        x = jnp.asarray(cplx.to_planar(x_np))
    else:
        x = jnp.asarray(np.asarray(x_np, np.float32))
    y, carry = step(x, carry)
    y = np.asarray(y)
    if y.ndim >= 1 and y.shape[-1] == 2:
        y = y[..., 0] + 1j * y[..., 1]
    return y, carry
