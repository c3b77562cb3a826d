"""North-star chain THROUGH THE BLOCK API: feeder -> /comms/fir_filter
-> /comms/fft -> sink, executed by the Topology scheduler with
auto-fusion (core/fusion.py), compared with bench.py's hand-compiled
chain on the same card.

Measurement discipline: pre-staged device inputs (DeviceChunks; the H2D
staging is outside the timed loop), and one value fetched from the last
spectra chunk after the timed loop (device execution is in order, so it
waits on every step dispatched before it).

Prints one JSON line {"metric": "fir_fft_topology_throughput", ...} with
the card's name and power limit; refuses to run without a GPU.

Run from the repo root: python benches/bench_topology.py
"""

import json
import sys
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    from pothoscomms_tpu.core.device import (card_name_and_power_limit,
                                             configure_compile_cache,
                                             require_gpu)

    require_gpu()
    configure_compile_cache()

    from pothoscomms_tpu import BlockRegistry, Topology
    from pothoscomms_tpu.core.block import Block
    from pothoscomms_tpu.core.fixtures import FeederSource
    from pothoscomms_tpu.core.fusion import DeviceChunk, to_planar_jax

    class ChecksumSink(Block):
        """Collects device chunks without touching them; checksum()
        fetches one value from the last, inside the timed region."""

        def __init__(self, dtype):
            super().__init__()
            from pothoscomms_tpu.core.dtypes import DType

            self.dtype = DType.parse(dtype)
            self.setup_input(0, self.dtype)
            self._chunks = []
            self._count = 0
            self._sum = jax.jit(jnp.sum)

        def work(self):
            port = self.input(0)
            n = port.elements()
            if n == 0:
                return
            self._chunks.extend(port.take(n))
            self._count += n

        def checksum(self):
            # the LAST result's value waits on every step dispatched
            # before it (device execution is in order)
            if not self._chunks:
                return 0.0
            last = self._chunks[-1]
            self._chunks.clear()
            return float(self._sum(to_planar_jax(last, self.dtype)))

    K, NBINS = 64, 1024
    CHUNK = 1 << 25          # elements per fed chunk (one MAX_QUANTUM)
    CHUNKS_PER_ITER = 4
    ITERS = 2
    rng = np.random.default_rng(0)
    taps = (rng.normal(size=K) + 1j * rng.normal(size=K)) / K

    fir = BlockRegistry.make("/comms/fir_filter", "complex_float32",
                             "COMPLEX")
    fir.set_taps(taps)
    fft = BlockRegistry.make("/comms/fft", "complex_float32", NBINS, False)
    feed = FeederSource("complex_float32")
    sink = ChecksumSink("complex_float32")

    topo = Topology()
    topo.connect(feed, 0, fir, 0)
    topo.connect(fir, 0, fft, 0)
    topo.connect(fft, 0, sink, 0)
    # edge sizing for the high-rate lane (the reference tunes buffer
    # managers per-port the same way, fft/FFT.cpp:54-59)
    fir.input(0).set_capacity(CHUNK * (CHUNKS_PER_ITER + 1))
    fft.input(0).set_capacity(CHUNK * 2)
    sink.input(0).set_capacity(CHUNK * 2)
    topo.commit()

    def stage_chunk(seed):
        arr = rng.normal(size=(CHUNK, 2)).astype(np.float32) * 0.05
        x = jnp.asarray(arr)
        jax.block_until_ready(x)
        return DeviceChunk(x, "complex_float32")

    def run_pass(chunks):
        """One full pass: feed, run to quiescence, force the checksum.
        Warmup and timed passes are IDENTICAL so every program the
        timed passes dispatch (fused steps at each ladder rung, pull
        slice/concat kernels, checksum sums) is compiled in warmup."""
        for ch in chunks:
            feed.feed_buffer(ch)
        assert topo.wait_inactive(timeout=1800.0)
        return sink.checksum()

    # pre-stage all inputs, fresh data per pass
    pools = [[stage_chunk(i * 100 + j) for j in range(CHUNKS_PER_ITER)]
             for i in range(ITERS + 1)]

    # K-1 primer: the first engage consumes the FIR history from the
    # queue; feeding it separately keeps every later chunk boundary
    # pull-aligned, so steady state re-uses a handful of compiled
    # slice shapes instead of compiling fresh ones every pass
    feed.feed_buffer(np.zeros(K - 1, np.complex64))

    warm_cs = run_pass(pools[-1])
    assert np.isfinite(warm_cs)
    seg = topo._segments[0]
    assert seg.engage_count >= 1, "segment never engaged"

    t0 = time.perf_counter()
    checksum = 0.0
    for i in range(ITERS):
        checksum += run_pass(pools[i])
    dt = (time.perf_counter() - t0) / ITERS
    assert np.isfinite(checksum)
    samples = CHUNK * CHUNKS_PER_ITER
    msamp = samples / dt / 1e6

    print(json.dumps({
        "metric": "fir_fft_topology_throughput",
        "value": round(msamp, 2),
        "unit": "Msamples/s",
        "fused_elements": seg.fused_elements,
        "engages": seg.engage_count,
        "device": jax.devices()[0].device_kind,
        "card": card_name_and_power_limit(),
    }))


if __name__ == "__main__":
    sys.exit(main())
