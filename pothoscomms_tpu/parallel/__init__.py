"""Device execution layer: planar-complex kernels, fused chains, sharding.

This is the performance path of the framework (the streaming block runtime
in ``core/`` is the semantics path). Design points (the formulations
were chosen for a float32-only accelerator; each is open again on the
GPU, which runs complex, integer and float64 HLOs natively):

- **Planar complex float32.** All fused device kernels
  take ``[..., 2]`` trailing (re, im) float32 arrays ("planar complex"),
  with complex arithmetic written out explicitly. Conversion helpers live
  in :mod:`pothoscomms_tpu.parallel.cplx`.
- **Channel-major batching.** Streams are processed as ``[channels, time]``
  blocks with a channel batch axis. This is the analog of the reference's SIMD-dispatch per-block loops
  (SURVEY.md §2.13).
- **Matmul FFT.** Fused-chain FFTs are computed as (two-factor)
  real DFT matmuls (:mod:`pothoscomms_tpu.parallel.fft`); the
  streaming FFT block uses ``jnp.fft``.
- **Fused chains.** A chain of blocks compiles into ONE jitted function
  over a time block with explicit carry state
  (:mod:`pothoscomms_tpu.parallel.chain`), eliminating per-block host
  round-trips.
- **Mesh sharding.** Multi-device scale-out shards channels across the mesh
  with ``shard_map``; stateful kernels exchange K-1-sample halos with
  ``ppermute`` when sharding along time
  (:mod:`pothoscomms_tpu.parallel.mesh`).
"""

from pothoscomms_tpu.parallel import cplx
from pothoscomms_tpu.parallel.fft import fft_planar, dft_matrices
from pothoscomms_tpu.parallel.chain import fir_fft_chain, make_fir_kernel

__all__ = ["cplx", "fft_planar", "dft_matrices", "fir_fft_chain",
           "make_fir_kernel"]
