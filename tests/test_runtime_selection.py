"""Runtime and route selection: `device` and `ref` work; the removed
kernel routes and platform runtimes are errors that name what exists."""

import numpy as np
import pytest

from bnn_pynq_tpu import cli
from bnn_pynq_tpu.compiler.finnthesizer import CompiledNetwork
from bnn_pynq_tpu.models import get_config
from bnn_pynq_tpu.models.network import init_random_params
from bnn_pynq_tpu.runtime.engine import InferenceEngine


def _compiled(name="sfc-w1a1"):
    cfg = get_config(name)
    layers = init_random_params(cfg, seed=0)
    return CompiledNetwork(
        config=cfg,
        layers=[{k: np.asarray(v) for k, v in l.items()} for l in layers],
        out_scale=np.ones(cfg.num_classes, np.float32),
        out_bias=np.zeros(cfg.num_classes, np.float32))


def test_default_runtime_is_device():
    eng = InferenceEngine(_compiled())
    assert eng.runtime == "device" and eng.route == "s2d"
    # the device runtime holds decoded int8 levels, never packed words
    assert all("w_packed" not in p for p in eng.params)


@pytest.mark.parametrize("runtime", ["device", "ref"])
def test_runtimes_agree(runtime):
    compiled = _compiled()
    x = np.random.default_rng(0).choice([-1, 1], size=(4, 784)).astype(
        np.int8)
    got = InferenceEngine(compiled, runtime=runtime).classify(
        x, prepared=True)
    want = InferenceEngine(compiled, runtime="ref").classify(
        x, prepared=True)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("route", ["mxu", "mxu_rm", "vpu", "fused",
                                   "direct", "mega"])
def test_removed_routes_raise(route):
    with pytest.raises(ValueError, match="routes are s2d, xla, xlaconv"):
        InferenceEngine(_compiled(), route=route)


@pytest.mark.parametrize("runtime", ["tpu", "interpret", "auto"])
def test_removed_runtimes_raise(runtime):
    with pytest.raises(ValueError, match="runtimes are device, ref"):
        InferenceEngine(_compiled(), runtime=runtime)


def test_cli_rejects_removed_route(capsys):
    with pytest.raises(SystemExit):
        cli.main(["bench", "x.npz", "--route", "mxu"])
    assert "invalid choice" in capsys.readouterr().err
