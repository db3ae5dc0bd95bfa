"""Test harness: run everything on CPU with 8 virtual devices so sharding
tests exercise a real Mesh without accelerator hardware (SURVEY.md §4). Must
run before the first jax import.

Tests marked `gpu` need an NVIDIA card and skip elsewhere (the `gpu_backend`
fixture decides at run time); run them on the card with
`JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

if os.environ["JAX_PLATFORMS"] == "cpu" and len(jax.devices()) < 8:
    jax.config.update("jax_num_cpu_devices", 8)  # XLA_FLAGS did not apply
# tests never read or write the on-disk compilation cache that the CLI's
# entry point enables (utils/compile_cache.py)
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np
import pytest


@pytest.fixture
def tone():
    """The reference e2e fixture: 0.12 s, 440 Hz, 8 kHz sine at half of
    int16 full scale (reference: test_e2e.py:6-10)."""
    sr = 8000
    t = np.linspace(0, 0.12, int(sr * 0.12), endpoint=False)
    amp = 0.5 * (2**15 - 1)
    sig = (amp * np.sin(2 * np.pi * 440.0 * t)).astype(np.int16)
    return sig.astype(np.float32), sr, 2


@pytest.fixture
def speechlike():
    """A longer, richer signal: chirp + harmonics + silence gaps, 16 kHz."""
    sr = 16000
    rng = np.random.default_rng(0)
    t = np.arange(int(sr * 1.0)) / sr
    sig = 0.4 * np.sin(2 * np.pi * (200 + 300 * t) * t)
    sig += 0.2 * np.sin(2 * np.pi * 800 * t)
    sig += 0.01 * rng.standard_normal(len(t))
    # carve silence gaps
    sig[int(0.3 * sr) : int(0.4 * sr)] = 0.0
    sig[int(0.7 * sr) : int(0.78 * sr)] = 0.0
    return (sig * 0.5 * (2**15 - 1)).astype(np.float32), sr, 2


@pytest.fixture
def gpu_backend():
    """Skip unless this process runs on an NVIDIA GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (backend is {jax.default_backend()})")


@pytest.fixture
def kernel_interpret(monkeypatch):
    """Route every encode-path call of the Pallas search kernel through the
    Pallas interpreter (explicit interpret=True) and count the calls at
    trace time, so a silently skipped kernel branch cannot turn a test
    into oracle-vs-oracle. Clears the jit caches around the test so every
    variant re-traces through the wrapper."""
    import fwav.ops.pallas_search as ps
    from fwav.models.encode import (
        _encode_core,
        _encode_core_chunked,
        _packed_encode_core,
        _sharded_encode_core,
    )

    caches = (_encode_core, _encode_core_chunked, _packed_encode_core,
              _sharded_encode_core)
    counts = {"scan_topc": 0}
    orig = ps.scan_topc

    def wrapped(*a, **kw):
        counts["scan_topc"] += 1
        return orig(*a, **{**kw, "interpret": True})

    monkeypatch.setattr(ps, "scan_topc", wrapped)
    for c in caches:
        c.cache_clear()
    yield counts
    for c in caches:
        c.cache_clear()
