"""chip_smoke.py on the CPU: it must refuse to run without a GPU, and its
comparison helpers must work at tiny size."""

import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from bnn_pynq_tpu.compiler.finnthesizer import CompiledNetwork
from bnn_pynq_tpu.models.config import (ConvSpec, DenseSpec, NetworkConfig,
                                        PoolSpec)
from bnn_pynq_tpu.models.network import init_random_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny(input_kind="int8", wbits=1, abits=1):
    if input_kind == "int8":
        cfg = NetworkConfig("tiny-cnv", wbits, abits, "int8", (10, 10, 3),
                            (ConvSpec(8), ConvSpec(8), PoolSpec(),
                             DenseSpec(16), DenseSpec(5)), 5)
    else:
        cfg = NetworkConfig("tiny-mlp", wbits, abits, "bipolar", (4, 4, 1),
                            (DenseSpec(16), DenseSpec(5)), 5)
    layers = init_random_params(cfg, seed=3)
    return CompiledNetwork(
        config=cfg,
        layers=[{k: np.asarray(v) for k, v in l.items()} for l in layers],
        out_scale=np.linspace(0.5, 1.5, 5).astype(np.float32),
        out_bias=np.linspace(-1, 1, 5).astype(np.float32))


def test_refuses_cpu_backend():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert '"phase": "device", "ok": false' in r.stdout


@pytest.mark.parametrize("kind,route", [
    ("int8", "s2d"), ("int8", "xla"), ("int8", "xlaconv"),
    ("bipolar", "xla")])
def test_check_exact_tiny(kind, route):
    compiled = _tiny(kind, 2 if kind == "int8" else 1, 2)
    images = chip_smoke.random_images(compiled.config, 3, seed=0)
    report = chip_smoke.check_exact(compiled, route, images)
    assert report["acc_exact"] and report["classes_exact"]
    assert report["logits_close"] and report["batch"] == 3


def test_check_exact_raises_on_mismatch():
    compiled = _tiny()
    images = chip_smoke.random_images(compiled.config, 2, seed=0)
    acc, logits, cls = chip_smoke.cpu_reference(compiled, images)
    with pytest.raises(AssertionError, match="differs"):
        chip_smoke.check_exact(compiled, "xla", images,
                               ref=(acc + 1, logits, cls))


def test_logits_close_scales_with_terms():
    acc = np.array([[1000, -3]], np.int32)
    scale = np.array([0.1, 0.1], np.float32)
    bias = np.array([-100.0, 0.3], np.float32)
    want = acc * scale.astype(np.float64) + bias
    # rounding-sized differences pass even where the result cancels to ~0
    # (tolerance 1e-6 · (|acc·scale| + |bias|) = 2e-4 and 6e-7 here)
    assert chip_smoke.logits_close(want + [[1e-5, 1e-7]], want, acc, scale,
                                   bias)
    assert not chip_smoke.logits_close(want + [[1e-3, 0]], want, acc, scale,
                                       bias)
    assert not chip_smoke.logits_close(want + [[0, 1e-6]], want, acc, scale,
                                       bias)


_GPU_HLO = """HloModule jit__fn, is_scheduled=true

%triton_gemm_dot (p0: s8[64,576], p1: s8[576,64]) -> s32[64,64] {
  %p0 = s8[64,576]{1,0} parameter(0)
  %p1 = s8[576,64]{1,0} parameter(1)
  ROOT %dot.1 = s32[64,64]{1,0} dot(%p0, %p1), lhs_contracting_dims={1}, rhs_contracting_dims={0}
}

%wrapped_dot_computation (param_0: s16[8,192], param_1: s16[192,16]) -> s16[8,16] {
  %param_0 = s16[8,192]{1,0} parameter(0)
  %param_1 = s16[192,16]{1,0} parameter(1)
  ROOT %dot.2 = s16[8,16]{1,0} dot(%param_0, %param_1), lhs_contracting_dims={1}, rhs_contracting_dims={0}
}

ENTRY %main.9 (a: s8[64,576], b: s8[576,64], c: s16[8,192], d: s16[192,16], e: bf16[1,8,8,3], f: bf16[3,3,3,4]) -> s32[64,64] {
  %a = s8[64,576]{1,0} parameter(0)
  %b = s8[576,64]{1,0} parameter(1)
  %custom-call.1 = (s32[64,64]{1,0}, s8[0]{0}) custom-call(%a, %b), custom_call_target="__cublas$gemm", backend_config={}
  %fusion.2 = s32[64,64]{1,0} fusion(%a, %b), kind=kCustom, calls=%triton_gemm_dot, backend_config={"fusion_backend_config":{"kind":"__triton_gemm"}}
  %wrapped_dot = s16[8,16]{1,0} fusion(%c, %d), kind=kLoop, calls=%wrapped_dot_computation
  %cudnn = (bf16[1,6,6,4]{3,2,1,0}, u8[0]{0}) custom-call(%e, %f), custom_call_target="__cudnn$convForward"
  ROOT %t = s32[64,64]{1,0} get-tuple-element(%custom-call.1), index=0
}
"""


def test_hlo_dot_summary_classifies_lowerings():
    s = chip_smoke.hlo_dot_summary(_GPU_HLO)
    assert s["cublas_gemm"] == 1 and s["triton_gemm"] == 1
    assert s["cudnn_conv"] == 1 and s["loop_fusion_dot"] == 1
    assert s["unfused_dot"] == 0 and not s["all_gemm"]
    # without the loop-fusion dot every dot is a GEMM
    clean = _GPU_HLO.replace(
        "  %wrapped_dot = s16[8,16]{1,0} fusion(%c, %d), kind=kLoop, "
        "calls=%wrapped_dot_computation\n", "").replace(
        "ROOT %dot.2 = s16[8,16]{1,0} dot(", "ROOT %add.2 = s16[8,16]{1,0} add(")
    assert chip_smoke.hlo_dot_summary(clean)["all_gemm"]


def test_hlo_dot_summary_on_a_cpu_program():
    import jax
    import jax.numpy as jnp
    f = jax.jit(lambda a, b: jnp.dot(a, b, preferred_element_type=jnp.int32))
    hlo = f.lower(jnp.ones((4, 8), jnp.int8),
                  jnp.ones((8, 2), jnp.int8)).compile().as_text()
    s = chip_smoke.hlo_dot_summary(hlo)
    # the CPU backend keeps the dot as an HLO dot: counted, not a GEMM call
    assert s["unfused_dot"] + s["loop_fusion_dot"] == 1
    assert s["cublas_gemm"] == 0
