"""Placement of the persistent XLA compilation cache: the directory in
JAX_COMPILATION_CACHE_DIR when set, else one fixed gitignored directory in
the checkout; the CLI's `--compile-cache off` leaves it untouched."""

import json
import os

import jax
import numpy as np
import pytest

from qwen3_tts_tpu import cli
from qwen3_tts_tpu.tts import engine as engine_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_config():
    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


def test_env_dir_wins(tmp_path, monkeypatch, restore_cache_config):
    target = tmp_path / "xla"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(target))
    assert engine_mod.enable_compilation_cache() == str(target)
    assert jax.config.jax_compilation_cache_dir == str(target)
    assert target.is_dir()


def test_default_dir_is_fixed_and_gitignored(monkeypatch,
                                             restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = engine_mod.enable_compilation_cache()
    assert got == engine_mod.DEFAULT_CACHE_DIR == os.path.join(
        REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("flag", ["on", "off"])
def test_cli_compile_cache_flag(flag, tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(engine_mod, "enable_compilation_cache",
                        lambda: calls.append(1))
    sdir = tmp_path / "speakers"
    sdir.mkdir()
    (sdir / "vivian.json").write_text(json.dumps(
        {"name": "vivian",
         "spk_emb": np.random.default_rng(0).normal(size=64).tolist()}))
    rc = cli.main([
        "--text", "cache", "--tiny", "--random-weights",
        "--speakers-dir", str(sdir), "--max-steps", "2",
        "--temperature", "0", "--seed", "1",
        "--output", str(tmp_path / "o.wav"), "--compile-cache", flag,
    ])
    assert rc == 0
    assert calls == ([1] if flag == "on" else [])
