"""Committed golden fixtures (SURVEY.md §4.5): artifacts + expected logits
generated once by the reference runtime. Any future change to packing
layouts, threshold conventions, artifact format, or kernel math that
breaks bit-compatibility fails here — the cross-round drift guard.
"""

import os

import numpy as np
import pytest

from bnn_pynq_tpu.runtime.engine import InferenceEngine

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.mark.parametrize("tag,runtime,route", [
    ("mlp_w1a1", "ref", "xla"),
    ("mlp_w1a1", "device", "s2d"),
    ("mlp_w1a1", "device", "xla"),
    ("mlp_w1a1", "device", "xlaconv"),
    ("cnv_w2a2", "ref", "xla"),
    ("cnv_w2a2", "device", "s2d"),
    ("cnv_w2a2", "device", "xla"),
    ("cnv_w2a2", "device", "xlaconv"),
])
def test_golden(tag, runtime, route):
    engine = InferenceEngine.from_artifact(
        os.path.join(FIXTURES, f"golden_{tag}.npz"),
        runtime=runtime, route=route)
    io = np.load(os.path.join(FIXTURES, f"golden_{tag}_io.npz"))
    got = engine.logits(io["x"])
    np.testing.assert_allclose(got, io["logits"], rtol=1e-5, atol=1e-5)
