import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip `gpu`-marked tests unless JAX's backend is a GPU. Decided
    here, per test, never at import: the suite runs under xdist, and
    every worker must collect the same tests."""
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; run on the card by "
                    "`python chip_smoke.py`")


@pytest.fixture(autouse=True)
def _private_compile_cache(tmp_path_factory, monkeypatch):
    """Entry points (cli.main, ...) turn on JAX's persistent compilation
    cache unless JAX_COMPILATION_CACHE_DIR is set; set it to a private
    directory so tests never write a shared cache in the checkout."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                       str(tmp_path_factory.mktemp("jax_cache")))
