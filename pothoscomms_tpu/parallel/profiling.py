"""Device profiling helpers (SURVEY.md §5: tracing is an addition the
reference lacks — Pothos only has topology stats in core).

- :func:`trace`: context manager around ``jax.profiler`` writing an
  xprof/tensorboard trace directory.
- :func:`annotate`: named trace region for host-side structuring.
- :func:`chain_flops`: analytic FLOP/byte model for the fused FIR+FFT
  chain — roofline accounting next to measured times.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import jax


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a device trace viewable in tensorboard/xprof:

        with profiling.trace("/tmp/trace"):
            spectra, carry = run(x, carry)
            spectra.block_until_ready()
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region inside a trace (host-side annotation)."""
    return jax.profiler.TraceAnnotation(name)


def chain_flops(channels: int, time: int, taps: int, nbins: int) -> dict:
    """FLOP/byte model of the fused FIR+FFT step (planar complex f32).

    - ``necessary``: the work of the naive formulation — a K-tap
      time-domain complex FIR (8 flops/complex MAC) plus a two-factor
      matmul FFT (N1+N2 complex MACs/sample + twiddle).
    - ``executed``: the production combined-operator path
      (parallel/chain.fir_fft_combined_step): (nbins + prev_pad=128)
      complex MACs per sample through Karatsuba 3-matmul complex
      multiplies (6 real flops per MAC), ~3x ``necessary``. Whether
      that trade pays on the GPU is open (ROADMAP §1.5).
    """
    samples = channels * time
    n1 = max(nbins // 128, 1)
    n2 = nbins // n1
    fft = (n1 + n2) * 8 + 6
    necessary = samples * (taps * 8 + fft)
    executed = samples * (nbins + 128) * 6
    bytes_moved = samples * 2 * 4 * 2  # planar in + spectra out
    return {
        "necessary_gflop": round(necessary / 1e9, 2),
        "executed_gflop": round(executed / 1e9, 2),
        "total_gflop": round(executed / 1e9, 2),  # back-compat alias
        "hbm_mbytes": round(bytes_moved / 1e6, 1),
    }
