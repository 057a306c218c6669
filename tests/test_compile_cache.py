"""The entry points' persistent compile cache, and the inference path's
independence from the training stack."""

import os
import subprocess
import sys

import jax
import pytest

from bnn_pynq_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_is_left_alone(monkeypatch, tmp_path, restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_unset_uses_checkout_dir(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(ROOT, ".jax_cache")
    assert compile_cache.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_cli_main_enables_the_cache(monkeypatch, restore_cache_config,
                                    capsys):
    from bnn_pynq_tpu.cli import main
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    main(["info"])
    assert jax.config.jax_compilation_cache_dir == os.path.join(
        ROOT, ".jax_cache")
    assert "cnv-w1a1" in capsys.readouterr().out


def test_cache_dir_is_gitignored():
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_inference_path_imports_no_flax():
    code = ("import sys; import chip_smoke, bench, "
            "bnn_pynq_tpu.cli, bnn_pynq_tpu.runtime.http_server, "
            "bnn_pynq_tpu.runtime.frontend, bnn_pynq_tpu.parallel.tp, "
            "bnn_pynq_tpu.parallel.overlap, bnn_pynq_tpu.compiler; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] == "
            "'flax'); assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-2000:]
