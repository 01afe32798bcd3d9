"""Persistent compilation cache placement (utils/cache.py).

Each case runs in a fresh interpreter: the cache directory is fixed when
the package is first imported."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str, cwd, env_extra: dict) -> str:
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO, **env_extra)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_env_var_dir_receives_entries(tmp_path):
    cache = tmp_path / "xla"
    code = (
        "import jax, os1_tpu\n"
        "from os1_tpu.utils.cache import enable_compilation_cache\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "jax.jit(lambda x: x * 2 + 1)(3.0).block_until_ready()\n"
        "print(enable_compilation_cache(), jax.config.jax_compilation_cache_dir)\n"
    )
    got = _run(code, tmp_path, {"JAX_COMPILATION_CACHE_DIR": str(cache)})
    assert got.split() == [str(cache), str(cache)]
    assert any(cache.iterdir()), "no cache entry was written to the env dir"


def test_default_dir_is_fixed_inside_checkout(tmp_path):
    code = (
        "import jax, os1_tpu\n"
        "from os1_tpu.utils.cache import enable_compilation_cache\n"
        "a, b = enable_compilation_cache(), enable_compilation_cache()\n"
        "assert a == b == jax.config.jax_compilation_cache_dir, (a, b)\n"
        "print(a)\n"
    )
    # Run from an unrelated working directory: the path must not follow cwd.
    got = _run(code, tmp_path, {})
    assert got == os.path.join(REPO, ".jax_cache")
