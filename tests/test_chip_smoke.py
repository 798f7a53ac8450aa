"""chip_smoke.py refuses to run where it cannot prove anything, and the
compile-cache helper puts JAX's persistent cache in one place."""

import os
import shutil
import subprocess
import sys

import jax

from cpp_cuda_raytracer_dev_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", compile_cache.ENV_VAR)}
    env.update(JAX_PLATFORMS="cpu", **extra)
    return env


def _run(args, cwd, env):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    r = _run(["chip_smoke.py"], REPO, _env())
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], str(tmp_path), _env())
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "ModuleNotFoundError" in r.stderr


def test_bench_refuses_cpu():
    r = _run(["bench.py", "--quick"], REPO, _env())
    assert r.returncode != 0
    assert "needs a GPU" in r.stderr
    assert r.stdout == ""


_COMPILE = ("import jax, jax.numpy as jnp; "
            "from cpp_cuda_raytracer_dev_tpu.utils.compile_cache import "
            "setup_compile_cache; print(setup_compile_cache()); "
            "jax.config.update('jax_persistent_cache_min_compile_time_secs',"
            " 0); jax.jit(lambda x: jnp.cos(x) * {k})(jnp.ones(5))"
            ".block_until_ready()")


def _entries(d):
    return {f for f in os.listdir(d) if f.startswith("jit__lambda")} \
        if os.path.isdir(d) else set()


def test_compile_cache_env_dir_only(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set the cache lands there and the
    helper sets no other directory."""
    cache = str(tmp_path / "cache")
    r = _run(["-c", _COMPILE.format(k=3.25)], REPO,
             _env(**{compile_cache.ENV_VAR: cache}))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == cache
    new = _entries(cache)
    assert new
    assert not new & _entries(compile_cache.DEFAULT_DIR)


def test_compile_cache_default_dir():
    """Unset, the cache goes to <repo>/.jax_cache."""
    assert compile_cache.DEFAULT_DIR == os.path.join(REPO, ".jax_cache")
    r = _run(["-c", _COMPILE.format(k=7.75)], REPO, _env())
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == compile_cache.DEFAULT_DIR
    assert _entries(compile_cache.DEFAULT_DIR)


def test_compile_cache_helper_in_process(monkeypatch):
    prev = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv(compile_cache.ENV_VAR, "/elsewhere")
        assert compile_cache.setup_compile_cache() == "/elsewhere"
        assert jax.config.jax_compilation_cache_dir == prev
        monkeypatch.delenv(compile_cache.ENV_VAR)
        assert (compile_cache.setup_compile_cache()
                == compile_cache.DEFAULT_DIR)
        assert (jax.config.jax_compilation_cache_dir
                == compile_cache.DEFAULT_DIR)
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)
