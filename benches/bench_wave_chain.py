"""The full device-resident pipeline through the BLOCK API:
waveform_source -> scale -> rotate -> fir -> fft as ONE source-headed
fused segment — on-device generation, elementwise hops, and the
FIR*DFT pair, zero H2D per quantum (VERDICT r3 next #2's named shape).
Refuses to run without a GPU; the result carries the card's name and
power limit.

Run from the repo root: python benches/bench_wave_chain.py
"""
import json
import sys
import time

import numpy as np

from pothoscomms_tpu import BlockRegistry, Topology
from pothoscomms_tpu.core.block import Block
from pothoscomms_tpu.core.dtypes import DType


class DrainSink(Block):
    def __init__(self, dtype):
        super().__init__()
        self.dtype = DType.parse(dtype)
        self.setup_input(0, self.dtype)
        self.input(0).set_capacity(None)
        self.last = None

    def work(self):
        port = self.input(0)
        n = port.elements()
        if n:
            self.last = port.take(n)[-1]


def main():
    from pothoscomms_tpu.core.device import (card_name_and_power_limit,
                                             configure_compile_cache,
                                             require_gpu)

    require_gpu()
    configure_compile_cache()
    rng = np.random.default_rng(3)
    K, NBINS = 64, 1024
    taps = (rng.normal(size=K) + 1j * rng.normal(size=K)) / K

    src = BlockRegistry.make("/comms/waveform_source", "complex_float32")
    src.set_waveform("SINE")
    src.set_frequency(1.217e6)
    src.set_sample_rate(30.72e6)
    sc = BlockRegistry.make("/comms/scale", "complex_float32")
    sc.set_factor(0.5)
    rot = BlockRegistry.make("/comms/rotate", "complex_float32")
    rot.set_phase(0.3)
    fir = BlockRegistry.make("/comms/fir_filter", "complex_float32",
                             "COMPLEX")
    fir.set_taps(taps)
    fft = BlockRegistry.make("/comms/fft", "complex_float32", NBINS, False)
    sink = DrainSink("complex_float32")

    topo = Topology()
    chain = [src, sc, rot, fir, fft, sink]
    for a, b in zip(chain[:-1], chain[1:]):
        topo.connect(a, 0, b, 0)
    topo.commit()

    total = 1 << 27  # 128 Mi samples
    # two warmups: the first pays the cold-start program, the second
    # the steady pair ladder; each ends in a sync
    for _ in range(2):
        topo.run_source_elements(total // 4)
        if sink.last is not None:
            float(np.abs(np.asarray(sink.last[-1:])).sum())
    t0 = time.perf_counter()
    topo.run_source_elements(total)
    if sink.last is not None:
        float(np.abs(np.asarray(sink.last[-1:])).sum())
    dt = time.perf_counter() - t0
    seg = topo._segments[0] if topo._segments else None
    print(json.dumps({
        "metric": "wave_chain_topology",
        "value": round(total / dt / 1e6, 1),
        "unit": "Msamples/s",
        "seg_blocks": len(seg.blocks) if seg else 0,
        "engages": seg.engage_count if seg else 0,
        "fused_elements": seg.fused_elements if seg else 0,
        "card": card_name_and_power_limit(),
    }))


if __name__ == "__main__":
    sys.exit(main())
