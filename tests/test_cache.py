"""Compile-cache location (pathtrace_tpu/utils/cache.py)."""

from unittest import mock

import jax

from pathtrace_tpu.utils import cache


def _run(monkeypatch, env):
    if env is None:
        monkeypatch.delenv(cache.ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(cache.ENV_VAR, env)
    with mock.patch.object(jax.config, "update") as update:
        path = cache.setup_compile_cache()
    return path, {c.args[0]: c.args[1] for c in update.call_args_list}


def test_env_var_wins_and_nothing_is_set(monkeypatch, tmp_path):
    path, updates = _run(monkeypatch, str(tmp_path))
    assert path == str(tmp_path)
    assert "jax_compilation_cache_dir" not in updates


def test_default_is_repo_jax_cache(monkeypatch):
    path, updates = _run(monkeypatch, None)
    assert path == cache.REPO_CACHE
    assert path.endswith(".jax_cache")
    assert updates["jax_compilation_cache_dir"] == cache.REPO_CACHE
