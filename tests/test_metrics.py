"""Roofline accounting sanity (SURVEY.md §5.1)."""

import json

import pytest

from bnn_pynq_tpu.models import get_config
from bnn_pynq_tpu.utils.metrics import (RunMetrics, chip_specs,
                                        int8_roofline_images_per_sec,
                                        network_macs, roofline_fraction)

H100 = "NVIDIA H100 80GB HBM3"


def test_network_macs_cnv_exact():
    # hand-computed: conv 1.5552M+28.9014M+10.6168M+14.7456M+2.6542M+0.5898M
    # + dense 0.1311M+0.2621M+0.0051M
    assert network_macs(get_config("cnv-w1a1")) == 59_461_376


def test_network_macs_lfc():
    assert network_macs(get_config("lfc-w1a1")) == \
        784 * 1024 + 2 * 1024 * 1024 + 1024 * 10


def test_roofline_positive():
    cfg = get_config("cnv-w1a1")
    chip = chip_specs(H100)
    sol = int8_roofline_images_per_sec(cfg, chip)
    # 1979e12 int8 ops/s over 2 * 59.46M MACs per image
    assert sol == pytest.approx(1979e12 / (2 * 59_461_376))
    assert 0 < roofline_fraction(cfg, sol / 2, chip) <= 0.51


def test_h100_row_has_datasheet_peaks():
    chip = chip_specs(H100)
    assert chip.device_kind == H100
    assert chip.int8_ops_per_sec == 1979e12
    assert chip.bf16_flops_per_sec == 989e12
    assert chip.hbm_bytes_per_sec == 3.35e12
    assert "data sheet" in chip.source


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB",
                                  ""])
def test_unknown_device_kind_raises(kind):
    with pytest.raises(KeyError, match="no peak rates"):
        chip_specs(kind)


def test_default_device_kind_is_the_jax_device():
    # the test backend is the CPU, which has no row: the default lookup
    # must raise rather than fall back to some other chip's peaks
    with pytest.raises(KeyError, match="cpu"):
        chip_specs()


def test_run_metrics_emit(tmp_path):
    m = RunMetrics("test").record(a=1.5, b=2)
    line = m.emit(str(tmp_path / "metrics.jsonl"))
    payload = json.loads(line)
    assert payload["a"] == 1.5 and payload["run"] == "test"
    assert (tmp_path / "metrics.jsonl").exists()
