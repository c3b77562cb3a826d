"""pothoscomms_tpu — a JAX DSP / software-radio framework.

A JAX/XLA implementation of the capabilities of
pothosware/PothosComms: a streaming dataflow
runtime (the part the reference borrows from Pothos core) plus the full
block catalog — elementwise math, FFT, FIR/IIR filters and designers,
waveform/noise sources, symbol coding, scramblers, PHY framing & sync,
FM demodulation, MAC/LLC packet layer, and scope utilities.

Architecture (not a port):

- **Functional cores** (`pothoscomms_tpu.ops`): every DSP kernel is a pure,
  jittable function ``(state, x) -> (state, y)`` over ``[channels, time]``
  arrays. These compile through XLA for the accelerator (an NVIDIA GPU)
  or the CPU. This replaces the reference's xsimd SIMD dispatch layer
  (reference: math/SIMD/*).
- **Streaming runtime** (`pothoscomms_tpu.core`): blocks, typed ports,
  labels, packets, signals/slots, probes, and a topology executor with
  consume/produce windowing semantics — the equivalent of the Pothos core
  scheduler the reference plugs into (reference: usage of
  <Pothos/Framework.hpp> throughout).
- **Parallel layer** (`pothoscomms_tpu.parallel`): channel/time sharding over
  a `jax.sharding.Mesh`, halo exchange via collectives for overlap-save
  filter boundaries, and a fused-chain compiler that pjit-compiles a whole
  block chain into one program per time-block.
"""

from pothoscomms_tpu.core.dtypes import DType
from pothoscomms_tpu.core.labels import Label
from pothoscomms_tpu.core.packet import Packet
from pothoscomms_tpu.core.block import Block
from pothoscomms_tpu.core.topology import Topology
from pothoscomms_tpu.core.registry import BlockRegistry, register_block

__version__ = "0.1.0"

__all__ = [
    "DType",
    "Label",
    "Packet",
    "Block",
    "Topology",
    "BlockRegistry",
    "register_block",
]


def _load_all_blocks():
    """Import every block module so factory registration side-effects run.

    Mirrors the reference's plugin auto-registration: each module's static
    ``Pothos::BlockRegistry`` objects register factories at .so load time
    (reference: math/Arithmetic.cpp:285-289).
    """
    import pothoscomms_tpu.blocks  # noqa: F401


_load_all_blocks()
