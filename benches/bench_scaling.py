"""Multi-device scaling rehearsal on virtual CPU devices.

The script always runs on XLA's host-platform devices (it respawns
itself under an 8-device CPU mesh) and never opens a GPU: wall-clock
numbers from virtual devices over shared cores say nothing about cards.
It reports what a CPU mesh CAN establish:

1. **SPMD parity** — the 8-device channel-sharded chain's output equals
   the single-device run (the partitioned program is correct).
2. **Work balance** — exact per-device shard sizes (channels split
   evenly => every device does identical work).
3. **Collective traffic, measured from the compiled HLO** — the count
   and byte volume of collective ops in the partitioned programs:
   - channel sharding: expected ZERO collectives in steady state;
   - time sharding: one K-1-sample collective-permute (halo) plus one
     small all-reduce (stream-tail replication) per step.
4. **Analytic projection** — with zero steady-state collective bytes
   and perfectly balanced shards, per-device throughput is constant in
   N; for time sharding, halo bytes per step vs per-step compute bound
   the overhead. Four-card numbers come from a run on the cards
   (ROADMAP §1.9).

Per-mesh-size wall-clock numbers are still printed, explicitly tagged
spmd-validation-only (host cores are oversubscribed).

Run: python benches/bench_scaling.py [--artifact PATH]
Prints one JSON line per aspect plus a summary line (and writes the
summary to PATH if given).
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEVICES = (1, 2, 4, 8)

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter",
                "collective-permute", "all-to-all")


def _respawn_under_cpu_mesh():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={max(DEVICES)}"
    ).strip()
    env["_BENCH_SCALING_CHILD"] = "1"
    return subprocess.call(
        [sys.executable, os.path.abspath(__file__)] + sys.argv[1:], env=env)


_SHAPE_RE = re.compile(r"(f32|bf16|s32|u32|pred)\[([0-9,]*)\]")


def hlo_collective_stats(hlo_text: str) -> dict:
    """Count collective ops and their payload bytes in compiled HLO."""
    stats = {}
    total_bytes = 0
    for line in hlo_text.splitlines():
        s = line.strip()
        for op in _COLLECTIVES:
            # match the op as the instruction (rhs), e.g.
            #   %x = f32[16,15,2] collective-permute(...)
            if f" {op}(" not in s and f" {op}-start(" not in s:
                continue
            m = _SHAPE_RE.search(s.split("=")[0] + "=" + s.split("=")[1]
                                 if "=" in s else s)
            nbytes = 0
            if m:
                dims = m.group(2)
                n = 1
                for d in dims.split(","):
                    if d:
                        n *= int(d)
                width = {"f32": 4, "bf16": 2, "s32": 4, "u32": 4,
                         "pred": 1}[m.group(1)]
                nbytes = n * width
            stats[op] = stats.get(op, 0) + 1
            total_bytes += nbytes
    stats["total_bytes_per_step_per_device"] = total_bytes
    return stats


def main():
    import numpy as np
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from pothoscomms_tpu.parallel.chain import fir_fft_chain
    from pothoscomms_tpu.parallel.mesh import (
        channel_sharded_fir_fft, make_mesh, time_sharded_fir)

    artifact_path = None
    if "--artifact" in sys.argv:
        artifact_path = sys.argv[sys.argv.index("--artifact") + 1]

    C, T, K, NBINS = 256, 8192, 64, 1024
    rng = np.random.default_rng(0)
    taps = (rng.normal(size=K) + 1j * rng.normal(size=K)) / K
    n_dev = min(8, len(jax.devices()))

    # ---------------- 1+2: SPMD parity + work balance ----------------- #
    mesh = make_mesh(n_dev)
    run, init_hist = channel_sharded_fir_fft(mesh, taps, NBINS)
    sh = NamedSharding(mesh, P("ch"))
    x_np = rng.normal(size=(C, T, 2)).astype(np.float32)
    x = jax.device_put(jnp.asarray(x_np), sh)
    hist = jax.device_put(init_hist(C), sh)
    spec, hist2 = run(x, hist)
    spec2, _ = run(x * jnp.float32(0.5), hist2)  # carry continuity

    run1, hist1 = fir_fft_chain(taps, NBINS, C, T)
    ref, rh = run1(jnp.asarray(x_np), hist1)
    ref2, _ = run1(jnp.asarray(x_np) * jnp.float32(0.5), rh)
    parity = bool(
        np.allclose(np.asarray(spec), np.asarray(ref), atol=1e-4)
        and np.allclose(np.asarray(spec2), np.asarray(ref2), atol=1e-4))
    shard_sizes = sorted(
        int(np.prod(s.data.shape)) for s in spec.addressable_shards)
    balance = (shard_sizes[0] / shard_sizes[-1]) if shard_sizes else 0.0
    print(json.dumps({"metric": "spmd_parity_8dev", "value": parity,
                      "work_balance_min_over_max": balance,
                      "shard_elements": shard_sizes}))

    # ---------------- 3: collective traffic from compiled HLO --------- #
    import inspect

    def compiled_hlo(fn, *args):
        return jax.jit(fn).lower(*args).compile().as_text()

    hlo_ch = compiled_hlo(lambda a, h: run(a, h), x, hist)
    ch_stats = hlo_collective_stats(hlo_ch)
    print(json.dumps({"metric": "collectives_channel_sharded",
                      **ch_stats}))

    mesh_t = Mesh(np.asarray(jax.devices()[:n_dev]), ("t",))
    run_t = time_sharded_fir(mesh_t, taps)
    sh_t = NamedSharding(mesh_t, P(None, "t"))
    xt = jax.device_put(jnp.asarray(x_np[:16]), sh_t)
    ct = jax.device_put(jnp.zeros((16, K - 1, 2), jnp.float32),
                        NamedSharding(mesh_t, P()))
    hlo_t = compiled_hlo(lambda a, c: run_t(a, c), xt, ct)
    t_stats = hlo_collective_stats(hlo_t)
    print(json.dumps({"metric": "collectives_time_sharded", **t_stats}))

    # ---------------- 4: analytic projection -------------------------- #
    # channel sharding: zero collective bytes + balanced shards =>
    # per-device work is constant in N; the only N-dependent cost is
    # program launch.
    halo_bytes = t_stats.get("total_bytes_per_step_per_device", 0)
    step_samples = 16 * T
    projection = {
        "metric": "scaling_projection",
        "channel_sharded_collective_bytes": ch_stats[
            "total_bytes_per_step_per_device"],
        "time_sharded_halo_bytes_per_step": halo_bytes,
        "halo_bytes_per_sample": round(halo_bytes / step_samples, 4),
        "note": ("channel sharding moves zero steady-state bytes -> "
                 "linear scaling expected on real chips (>=80% target); "
                 "time-sharded halo is K-1 samples per step per device, "
                 "amortized over the whole time slice"),
    }
    print(json.dumps(projection))

    # ---------------- wall-clock per mesh size (validation only) ------ #
    pern = {}
    for n in DEVICES:
        if n > len(jax.devices()):
            break
        mesh_n = make_mesh(n)
        run_n, init_n = channel_sharded_fir_fft(mesh_n, taps, NBINS)
        sh_n = NamedSharding(mesh_n, P("ch"))
        iters = 6
        pool = [jax.device_put(
            jnp.asarray(rng.normal(size=(C, T, 2)).astype(np.float32)),
            sh_n) for _ in range(iters)]
        h = jax.device_put(init_n(C), sh_n)
        s, h = run_n(pool[0], h)
        jax.block_until_ready(s)
        t0 = time.perf_counter()
        out = None
        for i in range(iters):
            out, h = run_n(pool[i], h)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / iters
        pern[n] = round(C * T / dt / 1e6, 2)
    print(json.dumps({"metric": "spmd_validation_msamp_s", "per_n": pern,
                      "mode": "spmd-validation-only",
                      "note": ("virtual host devices share one core "
                               "pool; NOT a device-scaling measurement")}))

    summary = {
        "metric": "scaling_artifact",
        "spmd_parity": parity,
        "work_balance_min_over_max": balance,
        "collectives_channel_sharded": ch_stats,
        "collectives_time_sharded": t_stats,
        "projection": projection["note"],
        "validation_msamp_s_per_n": pern,
        "platform": jax.devices()[0].platform,
    }
    print(json.dumps(summary))
    if artifact_path:
        with open(artifact_path, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    if os.environ.get("_BENCH_SCALING_CHILD"):
        sys.exit(main())
    sys.exit(_respawn_under_cpu_mesh())
