"""Raw-format ingestion tests (SURVEY.md C13 drivers): synthesize tiny
files in each canonical on-disk format, ingest, and check the arrays
round-trip exactly — so real data works the moment it is provisioned.
Plus the real-data Δ≤0.1% accuracy gate, skipped until data exists."""

import gzip
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from bnn_pynq_tpu.train import data as data_mod
from bnn_pynq_tpu.train.datasets_raw import ingest


def _write_idx(path, arr, gz=False):
    ndim = arr.ndim
    head = struct.pack(f">I{ndim}I", 0x0800 | ndim, *arr.shape)
    payload = head + arr.astype(np.uint8).tobytes()
    if gz:
        with gzip.open(path, "wb") as f:
            f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)


def test_mnist_idx_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    xtr = rng.integers(0, 256, (12, 28, 28)).astype(np.uint8)
    ytr = rng.integers(0, 10, 12).astype(np.uint8)
    xte = rng.integers(0, 256, (5, 28, 28)).astype(np.uint8)
    yte = rng.integers(0, 10, 5).astype(np.uint8)
    _write_idx(tmp_path / "train-images-idx3-ubyte.gz", xtr, gz=True)
    _write_idx(tmp_path / "train-labels-idx1-ubyte.gz", ytr, gz=True)
    _write_idx(tmp_path / "t10k-images-idx3-ubyte", xte)
    _write_idx(tmp_path / "t10k-labels-idx1-ubyte", yte)
    out = ingest("mnist", root=str(tmp_path))
    z = np.load(out)
    np.testing.assert_array_equal(z["x_train"], xtr[..., None])
    np.testing.assert_array_equal(z["y_test"], yte.astype(np.int32))
    # and data.load resolves it
    os.environ["BNN_DATA_DIR"] = str(tmp_path)
    try:
        ds = data_mod.load("mnist")
        assert not ds.synthetic
        np.testing.assert_array_equal(ds.x_test, xte[..., None])
    finally:
        del os.environ["BNN_DATA_DIR"]


def test_cifar10_bin_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    d = tmp_path / "cifar-10-batches-bin"
    d.mkdir()
    all_x, all_y = [], []
    for i in range(1, 6):
        y = rng.integers(0, 10, 4).astype(np.uint8)
        x = rng.integers(0, 256, (4, 3, 32, 32)).astype(np.uint8)
        rows = np.concatenate([y[:, None], x.reshape(4, -1)], axis=1)
        rows.tofile(d / f"data_batch_{i}.bin")
        all_x.append(x.transpose(0, 2, 3, 1))
        all_y.append(y)
    yt = rng.integers(0, 10, 3).astype(np.uint8)
    xt = rng.integers(0, 256, (3, 3, 32, 32)).astype(np.uint8)
    np.concatenate([yt[:, None], xt.reshape(3, -1)], axis=1).tofile(
        d / "test_batch.bin")
    out = ingest("cifar10", root=str(tmp_path))
    z = np.load(out)
    np.testing.assert_array_equal(z["x_train"], np.concatenate(all_x))
    np.testing.assert_array_equal(z["y_train"],
                                  np.concatenate(all_y).astype(np.int32))
    np.testing.assert_array_equal(z["x_test"], xt.transpose(0, 2, 3, 1))


def test_svhn_mat_roundtrip(tmp_path):
    scipy_io = pytest.importorskip("scipy.io")
    rng = np.random.default_rng(2)
    for split, n in (("train", 6), ("test", 4)):
        x = rng.integers(0, 256, (32, 32, 3, n)).astype(np.uint8)
        y = rng.integers(1, 11, (n, 1)).astype(np.uint8)   # MATLAB 1..10
        scipy_io.savemat(tmp_path / f"{split}_32x32.mat", {"X": x, "y": y})
    out = ingest("svhn", root=str(tmp_path))
    z = np.load(out)
    assert z["x_train"].shape == (6, 32, 32, 3)
    assert z["y_train"].min() >= 0 and z["y_train"].max() <= 9


def test_gtsrb_ppm_roundtrip(tmp_path):
    PIL_Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(3)
    base = tmp_path / "GTSRB" / "Final_Training" / "Images"
    for cls in (0, 7, 42):
        d = base / f"{cls:05d}"
        d.mkdir(parents=True)
        for j in range(4):
            img = rng.integers(0, 256, (40 + j, 40, 3)).astype(np.uint8)
            PIL_Image.fromarray(img).save(d / f"{j:05d}_{j:05d}.ppm")
    out = ingest("gtsrb", root=str(tmp_path))
    z = np.load(out)
    total = len(z["x_train"]) + len(z["x_test"])
    assert total == 12
    assert z["x_train"].shape[1:] == (32, 32, 3)
    assert set(np.concatenate([z["y_train"], z["y_test"]])) <= {0, 7, 42}


def test_gtsrb_roi_crop_and_split_contract(tmp_path):
    """Pins docs/preprocessing.md: frames are cropped to the annotation
    CSV's ROI before the bilinear resize, and a missing final-test CSV
    marks the holdout split NON-CANONICAL in the manifest."""
    PIL_Image = pytest.importorskip("PIL.Image")
    base = tmp_path / "GTSRB" / "Final_Training" / "Images"
    d = base / "00003"
    d.mkdir(parents=True)
    # frame: black everywhere except a white ROI box at [10:20, 5:15]
    img = np.zeros((40, 40, 3), np.uint8)
    img[10:20, 5:15] = 255
    PIL_Image.fromarray(img).save(d / "00000_00000.ppm")
    with open(d / "GT-00003.csv", "w") as f:
        f.write("Filename;Width;Height;Roi.X1;Roi.Y1;Roi.X2;Roi.Y2;"
                "ClassId\n")
        f.write("00000_00000.ppm;40;40;5;10;14;19;3\n")
    # second frame with NO annotation row → used uncropped
    PIL_Image.fromarray(img).save(d / "00001_00000.ppm")
    with open(d / "GT-00003.csv", "a") as f:
        pass
    out = ingest("gtsrb", root=str(tmp_path))
    z = np.load(out)
    xs = np.concatenate([z["x_train"], z["x_test"]])
    # the cropped frame resizes the all-white ROI → (nearly) all-white
    # 32×32; the uncropped one keeps mostly-black background
    means = sorted(float(x.mean()) for x in xs)
    assert means[-1] > 200, "ROI crop not applied (image not white)"
    assert means[0] < 80, "uncropped frame missing"
    manifest = "\n".join(str(s) for s in z["manifest"])
    assert "n_train_uncropped=1" in manifest
    assert "NON-CANONICAL" in manifest          # holdout fallback marked
    assert "crop=roi-csv" in manifest


def test_ingest_missing_files_message(tmp_path):
    with pytest.raises(FileNotFoundError):
        ingest("mnist", root=str(tmp_path))


def test_cli_ingest_and_gate(tmp_path):
    """cli ingest → cli eval --gate end-to-end on tiny fake MNIST."""
    rng = np.random.default_rng(4)
    _write_idx(tmp_path / "train-images-idx3-ubyte",
               rng.integers(0, 256, (8, 28, 28)).astype(np.uint8))
    _write_idx(tmp_path / "train-labels-idx1-ubyte",
               rng.integers(0, 10, 8).astype(np.uint8))
    _write_idx(tmp_path / "t10k-images-idx3-ubyte",
               rng.integers(0, 256, (4, 28, 28)).astype(np.uint8))
    _write_idx(tmp_path / "t10k-labels-idx1-ubyte",
               rng.integers(0, 10, 4).astype(np.uint8))
    env = dict(os.environ, BNN_DATA_DIR=str(tmp_path), JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "bnn_pynq_tpu.cli", "ingest", "mnist",
         "--root", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    # gate on (fake) real data: tiny random model fails the 95.8% baseline
    # → exit code 1 with gate FAILED — the gate has teeth
    r = subprocess.run(
        [sys.executable, "-m", "bnn_pynq_tpu.cli", "eval",
         "pretrained/sfc-w1a1.npz", "--runtime", "ref", "--gate"],
        capture_output=True, text=True, env=env, timeout=600,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 1, (r.stdout, r.stderr)
    assert '"gate": "FAILED"' in r.stdout
    assert '"synthetic_data": false' in r.stdout


# -- the real gate: runs only when genuine datasets are provisioned ---------

@pytest.mark.parametrize("artifact,dataset", [
    ("pretrained/lfc-w1a1.npz", "mnist"),
    ("pretrained/cnv-w1a1.npz", "cifar10"),
    ("pretrained/cnv-w2a2.npz", "cifar10"),
    ("pretrained/cnv-w2a2-svhn.npz", "svhn"),
    ("pretrained/cnv-w2a2-gtsrb.npz", "gtsrb"),
])
def test_accuracy_gate_real_data(artifact, dataset):
    ds = data_mod.load(dataset)
    if ds.synthetic:
        pytest.skip(f"no real {dataset} data provisioned")
    from bnn_pynq_tpu.runtime.engine import InferenceEngine
    from bnn_pynq_tpu.utils.baseline import gate
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    engine = InferenceEngine.from_artifact(os.path.join(root, artifact))
    correct = 0
    for i in range(0, len(ds.x_test), 1024):
        xs, ys = ds.x_test[i:i + 1024], ds.y_test[i:i + 1024]
        correct += int((engine.classify(xs) == ys).sum())
    top1 = correct / len(ds.x_test)
    passed, ref, delta = gate(engine.config.name, dataset, top1)
    assert passed, f"top1={top1:.4f} vs baseline {ref:.4f} (Δ={delta:+.4f})"
