"""chip_smoke.py's phases at tiny sizes on the CPU, its refusal to run
without a GPU, the compile-cache setup, and the absence of any device
routing by dtype. The full-size run needs a card:

    python chip_smoke.py
"""

import jax
import numpy as np
import pytest

import chip_smoke
from pothoscomms_tpu import BlockRegistry
from pothoscomms_tpu.core import device


def test_main_exits_nonzero_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    assert chip_smoke.main(["--four-cards"]) != 0
    assert capsys.readouterr().out == ""  # no result line


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="GPU"):
        device.require_gpu()


def test_reference_fir_matches_direct_convolution():
    rng = np.random.default_rng(0)
    taps = chip_smoke.complex_taps(9, 1)
    x = chip_smoke.uniform_complex(rng, (2, 10000))
    hist = chip_smoke.uniform_complex(rng, (2, 8))
    got = chip_smoke.ref_fir(x, taps, hist, block=256)
    for c in range(2):
        exp = np.convolve(np.concatenate([hist[c], x[c]]), taps)[8: 8 + 10000]
        np.testing.assert_allclose(got[c], exp, atol=1e-12)


def test_phase_topology_tiny():
    res = chip_smoke.phase_topology(chunk=1 << 16, n_chunks=3)
    assert res["quantum"] == 1 << 16
    assert res["max_abs_err"] < res["tol_abs"]


def test_phase_chain_tiny():
    res = chip_smoke.phase_chain(c=4, t=8192, iters=2)
    assert res["max_abs_err"] < res["tol_abs"]
    assert res["plain_xla_max_abs_err"] < res["tol_abs"]


def test_phase_precision_writes_hlo(tmp_path):
    res = chip_smoke.phase_precision(out_dir=tmp_path)
    assert any(k.startswith("pair step") for k in res)
    assert list(tmp_path.glob("hlo_*.txt"))
    for entry in res.values():
        assert entry.get("rel_err", 0.0) < 1e-3


def test_phase_dtypes_tiny():
    res = chip_smoke.phase_dtypes(n=8192, nbins=256, threshold=4096)
    assert res["float64_iir"]["max_abs_err"] < 1e-12
    assert res["complex_int16_fft"]["fused_vs_streaming_mismatches"] == 0


def test_phase_modem_tiny():
    res = chip_smoke.phase_modem(n_bits=1 << 15, threshold=4096)
    assert res["bit_exact"] and res["fused_elements"] > 0


def test_phase_four_cards_on_virtual_devices():
    res = chip_smoke.phase_four_cards(c=8, t=4096, k=16, nbins=256,
                                      link_channels=8)
    assert res["sharded_digital_link"]["bit_exact"]


def test_compile_cache_uses_env_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert device.configure_compile_cache() == str(tmp_path)
    assert calls == []  # JAX reads the variable itself


def test_compile_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    path = device.configure_compile_cache()
    root = chip_smoke.ROOT
    assert path == str(root / ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    ignored = (root / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


@pytest.mark.parametrize("dtype", ["int16", "complex_float32",
                                   "complex_int16", "float64"])
def test_block_jit_enters_no_device_scope(monkeypatch, dtype):
    def refuse(*a, **k):
        raise AssertionError("default_device scope entered")

    monkeypatch.setattr(jax, "default_device", refuse)
    blk = BlockRegistry.make("/comms/arithmetic", dtype, "ADD")
    fn = blk.jit(lambda a: a + a)
    x = np.arange(6, dtype=np.int16).reshape(3, 2) if dtype == \
        "complex_int16" else np.ones(4, blk.dtype.np)
    out = fn(x)
    assert list(out.devices())[0] == jax.devices()[0]


@pytest.mark.gpu
def test_chip_smoke_phases_on_gpu(gpu_device):
    assert jax.devices()[0] == gpu_device
    assert chip_smoke.phase_topology(chunk=1 << 16, n_chunks=3)[
        "max_abs_err"] < chip_smoke.FFT_TOL
    chip_smoke.phase_dtypes(n=8192, nbins=256, threshold=4096)
    chip_smoke.phase_modem(n_bits=1 << 15, threshold=4096)
