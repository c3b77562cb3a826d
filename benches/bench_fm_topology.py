"""BASELINE config #4 THROUGH THE BLOCK API: noise_source ->
freq_demod -> dc_removal -> envelope_detector built as a Topology, with
the auto-fusion executor engaging the whole chain as one source-headed
segment (device-side generation, zero H2D per quantum).

Prints one JSON line with fused and streaming-path throughput. The
number measures the PRODUCT path — the scheduler delivering device
execution by default — not a hand-compiled chain (that number lives in
bench_suite.py fm_chain_256ch). Refuses to run without a GPU; the
result carries the card's name and power limit.

Run from the repo root: python benches/bench_fm_topology.py
"""
import json
import sys
import time

import numpy as np

from pothoscomms_tpu import BlockRegistry, Topology
from pothoscomms_tpu.core.block import Block
from pothoscomms_tpu.core.dtypes import DType


class DrainSink(Block):
    """Counts elements; keeps only the newest part so a long bench run
    holds RSS flat. Forces a device sync on the final part at finish."""

    def __init__(self, dtype):
        super().__init__()
        self.dtype = DType.parse(dtype)
        self.setup_input(0, self.dtype)
        self.input(0).set_capacity(None)
        self.count = 0
        self.last = None

    def work(self):
        port = self.input(0)
        n = port.elements()
        if n == 0:
            return
        parts = port.take(n)
        self.count += n
        self.last = parts[-1]


def build(fuse: bool, seed=11):
    src = BlockRegistry.make("/comms/noise_source", "complex_float32", seed)
    src.set_waveform("NORMAL")
    src.set_fast(True)
    demod = BlockRegistry.make("/comms/freq_demod", "complex_float32")
    dc = BlockRegistry.make("/comms/dc_removal", "float32")
    dc.set_average_size(32)
    dc.set_cascade_size(2)
    env = BlockRegistry.make("/comms/envelope_detector", "float32")
    env.set_attack(4.0)
    env.set_release(16.0)
    sink = DrainSink("float32")
    topo = Topology()
    topo.auto_fuse = fuse
    chain = [src, demod, dc, env, sink]
    for a, b in zip(chain[:-1], chain[1:]):
        topo.connect(a, 0, b, 0)
    topo.commit()
    return topo, src, sink


def run(fuse: bool, total: int):
    topo, src, sink = build(fuse)
    # warmup: compile the quantum ladder
    topo.run_source_elements(total // 4)
    if sink.last is not None:
        float(np.asarray(sink.last[-1:]).sum())
    t0 = time.perf_counter()
    topo.run_source_elements(total)
    # fetch the final device value: device execution is in order
    if sink.last is not None:
        float(np.asarray(sink.last[-1:]).sum())
    dt = time.perf_counter() - t0
    seg = topo._segments[0] if topo._segments else None
    return total / dt, seg


def main():
    from pothoscomms_tpu.core.device import (card_name_and_power_limit,
                                             configure_compile_cache,
                                             require_gpu)

    require_gpu()
    configure_compile_cache()
    total = 1 << 27  # 128 Mi samples
    rate_fused, seg = run(True, total)
    rate_stream, _ = run(False, total // 16)
    out = {
        "metric": "fm_chain_topology",
        "value": round(rate_fused / 1e6, 1),
        "unit": "Msamples/s",
        "engaged": seg.engage_count if seg else 0,
        "seg_blocks": len(seg.blocks) if seg else 0,
        "fused_elements": seg.fused_elements if seg else 0,
        "streaming_msamp_s": round(rate_stream / 1e6, 1),
        "speedup_vs_streaming": round(rate_fused / rate_stream, 1),
        "card": card_name_and_power_limit(),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    sys.exit(main())
