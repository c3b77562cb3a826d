"""Multi-host runtime setup (jax.distributed) + mesh construction.

The reference's only cross-process story is the Pothos TCP remote proxy
(SURVEY.md §2.13(4)); the equivalent mandated by BASELINE.md is a
multi-host mesh: every host calls :func:`initialize`, then builds a
global mesh with :func:`make_global_mesh` and runs the same
channel/time-sharded chains from :mod:`pothoscomms_tpu.parallel.mesh` —
XLA routes collectives between the cards of a host over NVLink and
cross-host legs over the network.

Single-process multi-device simulation (CI): set
``XLA_FLAGS=--xla_force_host_platform_device_count=N JAX_PLATFORMS=cpu``
and skip :func:`initialize`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Bring up the multi-host runtime (idempotent).

    Pass the arguments explicitly; nothing on a plain GPU host
    describes the cluster to JAX:

        initialize("10.0.0.1:8476", num_processes=4, process_id=rank)
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        if "already initialized" not in str(e):
            raise


def make_global_mesh(axis: str = "ch",
                     devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over every device in the job (all hosts)."""
    devs = list(devices) if devices is not None else jax.devices()
    return Mesh(np.asarray(devs), (axis,))


def make_2d_mesh(ch: int, t: int) -> Mesh:
    """[channel, time] mesh: channels stay intra-host where possible so
    the (channel-local) halo exchange of time sharding rides NVLink."""
    devs = np.asarray(jax.devices())
    if devs.size != ch * t:
        raise ValueError(f"need {ch * t} devices, have {devs.size}")
    return Mesh(devs.reshape(ch, t), ("ch", "t"))


def scaling_efficiency(samples_per_s: dict) -> dict:
    """Given {n_devices: samples_per_s}, efficiency vs linear scaling
    from the smallest configuration (the BASELINE.md >=80% criterion)."""
    base_n = min(samples_per_s)
    base = samples_per_s[base_n] / base_n
    return {
        n: round(v / (n * base), 4) for n, v in samples_per_s.items()
    }
