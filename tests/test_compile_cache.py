"""The persistent compile cache's one rule (utils/compile_cache.py): a set
JAX_COMPILATION_CACHE_DIR is left to JAX, otherwise a fixed path in the
checkout."""

import os

import jax

from cuking_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _record_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_env_var_set_leaves_cache_to_jax(monkeypatch):
    calls = _record_updates(monkeypatch)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/else")
    compile_cache.enable_compile_cache()
    assert calls == []


def test_env_var_unset_uses_fixed_checkout_path(monkeypatch):
    calls = _record_updates(monkeypatch)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    compile_cache.enable_compile_cache()
    assert calls == [
        ("jax_compilation_cache_dir", os.path.join(REPO, ".jax_cache"))
    ]
    assert os.path.isabs(calls[0][1])
