"""Where the persistent compilation cache lives (utils/compcache.py)."""

import os
import subprocess
import sys

from sgracex1_tpu.utils import compcache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_default_dir_is_fixed_inside_the_checkout():
    assert compcache.CACHE_DIR == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_env_dir_wins_and_sets_nothing(monkeypatch):
    import jax

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert compcache.enable_persistent_cache() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before


def _cache_dir_in_fresh_process(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    code = (
        "import jax; from sgracex1_tpu.utils.compcache import "
        "enable_persistent_cache as e; r = e(); "
        "print(r); print(jax.config.jax_compilation_cache_dir)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, check=True,
        capture_output=True, text=True, timeout=120,
    ).stdout.split()
    return out


def test_fresh_process_without_env_uses_fixed_dir():
    returned, configured = _cache_dir_in_fresh_process(None)
    assert returned == configured == compcache.CACHE_DIR


def test_fresh_process_with_env_lets_jax_read_it(tmp_path):
    env_dir = str(tmp_path / "cache")
    returned, configured = _cache_dir_in_fresh_process(env_dir)
    # jax reads JAX_COMPILATION_CACHE_DIR itself; the module set nothing
    assert returned == configured == env_dir
