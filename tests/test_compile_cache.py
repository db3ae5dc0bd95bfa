"""utils/compile_cache: where JAX's persistent compilation cache goes."""

import os

import jax
import numpy as np
import pytest

from fwav.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache_config():
    """Restore jax_compilation_cache_dir after the test (the conftest keeps
    the cache itself disabled, so nothing is written either way)."""
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_env_var_wins_and_code_sets_nothing(monkeypatch, tmp_path, cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_the_checkout_jax_cache(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = compile_cache.enable_compile_cache()
    assert d == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == d
    # a fixed path: the same on every call, never a temp or per-process dir
    assert compile_cache.enable_compile_cache() == d
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cli_enables_cache_only_for_device_commands(monkeypatch, tmp_path):
    from fwav.cli import main
    from fwav.io.wav import write_wav

    calls = []
    monkeypatch.setattr(compile_cache, "enable_compile_cache",
                        lambda: calls.append(1))
    t = np.arange(8000) / 8000.0
    write_wav(str(tmp_path / "a.wav"),
              (np.sin(2 * np.pi * 440 * t) * 12000).astype(np.float32), 8000, 2)
    assert main(["snr", str(tmp_path / "a.wav"), str(tmp_path / "a.wav")]) == 0
    assert calls == []
    assert main(["compress", str(tmp_path / "a.wav"), str(tmp_path / "a.fwav"),
                 "--tile", "128"]) == 0
    assert calls == [1]
