"""Worker for the two-process jax.distributed test (SURVEY.md §4 item 9).

Each process owns 4 virtual CPU devices; the two processes form one
8-device global mesh via jax.distributed. The channel-sharded FIR+FFT
chain runs over the global mesh; every process checks its addressable
output shards against a locally computed single-device reference.

Usage: distributed_worker.py <rank> <num_processes> <port>
"""

import os
import sys

rank = int(sys.argv[1])
nprocs = int(sys.argv[2])
port = int(sys.argv[3])

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4"
).strip()

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from pothoscomms_tpu.parallel.distributed import (  # noqa: E402
    initialize,
    make_global_mesh,
)
from pothoscomms_tpu.parallel.mesh import channel_sharded_fir_fft  # noqa: E402
from pothoscomms_tpu.parallel.chain import fir_fft_chain  # noqa: E402

initialize(f"localhost:{port}", num_processes=nprocs, process_id=rank)

assert jax.process_count() == nprocs, jax.process_count()
assert len(jax.local_devices()) == 4
assert len(jax.devices()) == 4 * nprocs

C, T, K, NBINS = 16, 2048, 16, 256
rng = np.random.default_rng(42)  # same seed everywhere: same global data
taps = (rng.normal(size=K) + 1j * rng.normal(size=K)) / K
x_np = rng.normal(size=(C, T, 2)).astype(np.float32)

mesh = make_global_mesh("ch")
run, init_history = channel_sharded_fir_fft(mesh, taps, NBINS)

from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

sh_x = NamedSharding(mesh, P("ch"))
x = jax.make_array_from_callback(x_np.shape, sh_x,
                                 lambda idx: x_np[idx])
h_np = np.zeros((C, K - 1, 2), np.float32)
h = jax.make_array_from_callback(h_np.shape, sh_x,
                                 lambda idx: h_np[idx])

spec, hist = run(x, h)

# local single-device reference (same formulation) for the shards
run_ref, _ = fir_fft_chain(taps, NBINS, C, T)
ref_spec, ref_hist = run_ref(jnp.asarray(x_np), jnp.asarray(h_np))
ref_spec = np.asarray(ref_spec)

checked = 0
for shard in spec.addressable_shards:
    got = np.asarray(shard.data)
    sl = shard.index
    exp = ref_spec[sl]
    np.testing.assert_allclose(got, exp, atol=1e-4)
    checked += got.size

assert checked > 0

# ---------------------------------------------------------------- #
# Time-sharded FIR over the SAME global mesh re-axised as a "t"
# ring: the K-1 overlap-save halos travel right via lax.ppermute,
# and with 8 devices split across 2 processes the exchange at the
# 3|4 boundary crosses the process boundary — the actual inter-device
# traffic of the north star (round-2 verdict missing #3).
# ---------------------------------------------------------------- #
from jax.sharding import Mesh  # noqa: E402

from pothoscomms_tpu.parallel.chain import (  # noqa: E402
    complex_fir_kernel,
    fir_multichannel,
)
from pothoscomms_tpu.parallel.mesh import (  # noqa: E402
    grid_sharded_fir,
    time_sharded_fir,
)

carry_np = rng.normal(size=(C, K - 1, 2)).astype(np.float32)
kern = complex_fir_kernel(taps)
y_ref, tail_ref = fir_multichannel(jnp.asarray(x_np), jnp.asarray(carry_np),
                                   kern)
y_ref = np.asarray(y_ref)
tail_ref = np.asarray(tail_ref)

mesh_t = Mesh(np.asarray(jax.devices()), ("t",))
run_t = time_sharded_fir(mesh_t, taps)
sh_t = NamedSharding(mesh_t, P(None, "t"))
sh_rep = NamedSharding(mesh_t, P())
x_t = jax.make_array_from_callback(x_np.shape, sh_t, lambda idx: x_np[idx])
c_t = jax.make_array_from_callback(carry_np.shape, sh_rep,
                                   lambda idx: carry_np[idx])
y_t, tail_t = run_t(x_t, c_t)
checked_t = 0
for shard in y_t.addressable_shards:
    np.testing.assert_allclose(np.asarray(shard.data), y_ref[shard.index],
                               atol=1e-4)
    checked_t += np.asarray(shard.data).size
assert checked_t > 0
for shard in tail_t.addressable_shards:
    np.testing.assert_allclose(np.asarray(shard.data),
                               tail_ref[shard.index], atol=1e-4)

# 2-D [ch, t] grid: channel split across processes, 4-device time
# ring per channel group (halos again via ppermute)
mesh_g = Mesh(np.asarray(jax.devices()).reshape(2, 4), ("ch", "t"))
run_g = grid_sharded_fir(mesh_g, taps)
sh_g = NamedSharding(mesh_g, P("ch", "t"))
sh_gc = NamedSharding(mesh_g, P("ch"))
x_g = jax.make_array_from_callback(x_np.shape, sh_g, lambda idx: x_np[idx])
c_g = jax.make_array_from_callback(carry_np.shape, sh_gc,
                                   lambda idx: carry_np[idx])
y_g, tail_g = run_g(x_g, c_g)
checked_g = 0
for shard in y_g.addressable_shards:
    np.testing.assert_allclose(np.asarray(shard.data), y_ref[shard.index],
                               atol=1e-4)
    checked_g += np.asarray(shard.data).size
assert checked_g > 0

print(f"WORKER{rank} OK checked={checked} halo_t={checked_t} "
      f"halo_grid={checked_g}", flush=True)
