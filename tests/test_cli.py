"""CLI end-to-end: train → artifact → classify → info (SURVEY.md C15)."""

import os

import numpy as np
import pytest

from bnn_pynq_tpu import cli


def test_info_lists_networks(capsys):
    cli.main(["info"])
    out = capsys.readouterr().out
    assert "cnv-w1a1" in out and "lfc-w1a2" in out


def test_info_plan(capsys):
    cli.main(["info", "cnv-w2a2"])
    out = capsys.readouterr().out
    assert "W2A2" in out and "conv_int8" in out


def test_train_compile_classify_roundtrip(tmp_path, capsys, monkeypatch):
    # tiny synthetic run through the real CLI paths
    monkeypatch.setenv("BNN_DATA_DIR", str(tmp_path / "nodata"))
    out_dir = str(tmp_path / "artifacts")
    cli.main(["train", "sfc-w1a1", "--epochs", "1", "--batch-size", "256",
              "--out", out_dir])
    captured = capsys.readouterr().out
    assert "artifact:" in captured
    artifact = os.path.join(out_dir, "sfc-w1a1.npz")
    assert os.path.exists(artifact)
    assert os.path.exists(os.path.join(out_dir, "sfc-w1a1-checkpoint.npz"))

    # compile from the checkpoint path too
    cli.main(["compile", os.path.join(out_dir, "sfc-w1a1-checkpoint.npz"),
              "--network", "sfc-w1a1", "--out", str(tmp_path / "c2.npz")])
    assert os.path.exists(tmp_path / "c2.npz")

    imgs = np.random.default_rng(0).integers(
        0, 256, size=(3, 28, 28, 1)).astype(np.uint8)
    img_path = str(tmp_path / "imgs.npy")
    np.save(img_path, imgs)
    cli.main(["classify", artifact, img_path, "--runtime", "ref"])
    out = capsys.readouterr().out
    assert "usecPerImage" in out


def test_gate_all_skips_without_data(tmp_path, capsys, monkeypatch):
    """`gate-all` with an empty data dir: every row skipped, exit 0."""
    import json
    from bnn_pynq_tpu.cli import main
    monkeypatch.setenv("BNN_DATA_DIR", str(tmp_path / "empty"))
    monkeypatch.chdir(tmp_path)
    main(["gate-all", "--artifacts", str(tmp_path / "arts")])
    lines = [json.loads(l) for l in
             capsys.readouterr().out.strip().splitlines()]
    assert lines[-1] == {"summary": "skipped x10", "failed": False}
    assert all("skipped" in r["gate"] for r in lines[:-1])


def test_gate_all_trains_and_gates_on_real_data(tmp_path, capsys,
                                                monkeypatch):
    """With a (tiny fake) real mnist.npz present, gate-all must produce
    unattended Δ rows for the mnist workloads — train → eval → gate —
    and exit 1 (random data can't pass the Δ≤0.1% gate)."""
    import json
    import numpy as np
    import pytest
    from bnn_pynq_tpu.cli import main
    rng = np.random.default_rng(0)
    data = tmp_path / "data"
    data.mkdir()
    np.savez(data / "mnist.npz",
             x_train=rng.integers(0, 256, size=(96, 28, 28, 1)
                                  ).astype(np.uint8),
             y_train=rng.integers(0, 10, size=96).astype(np.int32),
             x_test=rng.integers(0, 256, size=(32, 28, 28, 1)
                                 ).astype(np.uint8),
             y_test=rng.integers(0, 10, size=32).astype(np.int32))
    monkeypatch.setenv("BNN_DATA_DIR", str(data))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit):
        main(["gate-all", "--train", "--epochs", "1", "--batch", "32",
              "--artifacts", str(tmp_path / "arts"),
              "--runtime", "device"])
    rows = {r["network"]: r for r in
            (json.loads(l) for l in
             capsys.readouterr().out.strip().splitlines())
            if "network" in r}
    sfc = rows["sfc-w1a1"]
    assert sfc["gate"] in ("passed", "FAILED")
    assert "top1_accuracy" in sfc and "delta" in sfc
    assert "trained" in sfc                      # artifact was trained
    assert "skipped" in rows["cnv-w1a1"]["gate"]  # no cifar data


def test_cli_reload_roundtrip(tmp_path, capsys):
    """`cli reload <artifact> --url ...` swaps weights on a live serve
    host (operator-side zero-downtime rollout, r5)."""
    import numpy as np
    from bnn_pynq_tpu.cli import main
    from bnn_pynq_tpu.compiler import compile_network, save_artifact
    from bnn_pynq_tpu.runtime.engine import InferenceEngine
    from bnn_pynq_tpu.runtime.http_server import serve
    from tests.test_finnthesizer import init_perturbed, mini_cnv

    cfg = mini_cnv(1, 1)
    _, p1, s1 = init_perturbed(cfg, seed=70)
    _, p2, s2 = init_perturbed(cfg, seed=71)
    c1, c2 = compile_network(cfg, p1, s1), compile_network(cfg, p2, s2)
    a1, a2 = str(tmp_path / "a1.npz"), str(tmp_path / "a2.npz")
    save_artifact(a1, c1)
    save_artifact(a2, c2)
    httpd, batcher = serve(a1, port=0, runtime="ref", block=False)
    try:
        port = httpd.server_address[1]
        main(["reload", a2, "--url", f"http://127.0.0.1:{port}"])
        out = capsys.readouterr().out
        assert '"reloaded"' in out
        rng = np.random.default_rng(72)
        imgs = rng.integers(0, 256, size=(3, 10, 10, 3)).astype(np.uint8)
        import io, urllib.request
        buf = io.BytesIO(); np.savez(buf, x=imgs)
        import json as _json
        r = _json.loads(urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}/classify", data=buf.getvalue()),
            timeout=60).read())
        np.testing.assert_array_equal(
            r["classes"], InferenceEngine(c2, runtime="ref").classify(imgs))
    finally:
        httpd.shutdown()
        batcher.stop()
