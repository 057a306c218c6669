"""Per-workload demo — the script analogue of the reference's notebooks
(SURVEY.md C17 «notebooks/CNV-BNN_Cifar10.ipynb» etc.): for one dataset,
load the pretrained artifact, classify the test set, and print top-1
accuracy, per-image latency, and the HW-vs-SW runtime comparison
(the `device` runtime vs the bit-exact `ref` software twin — the
RUNTIME_HW/RUNTIME_SW duality of «bnn/bnn.py»).

    python examples/workload_demo.py mnist     [--artifact ...]
    python examples/workload_demo.py cifar10
    python examples/workload_demo.py svhn
    python examples/workload_demo.py gtsrb

With real data provisioned (see `cli ingest`) the accuracy is the
BASELINE.md gate number; on synthetic data it demos the pipeline only.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

DEFAULT_ARTIFACTS = {
    "mnist": "pretrained/lfc-w1a1.npz",
    "cifar10": "pretrained/cnv-w1a1.npz",
    "svhn": "pretrained/cnv-w2a2-svhn.npz",
    "gtsrb": "pretrained/cnv-w2a2-gtsrb.npz",
}


def evaluate(engine, ds, batch, limit=None):
    n = len(ds.x_test) if limit is None else min(limit, len(ds.x_test))
    correct = 0
    t0 = time.perf_counter()
    for i in range(0, n, batch):
        hi = min(i + batch, n)
        xs, ys = ds.x_test[i:hi], ds.y_test[i:hi]
        correct += int((engine.classify(xs) == ys).sum())
    dt = time.perf_counter() - t0
    return correct / n, dt / n * 1e6, n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset", choices=list(DEFAULT_ARTIFACTS))
    ap.add_argument("--artifact", default=None)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--limit", type=int, default=None,
                    help="evaluate only the first N test images")
    ap.add_argument("--route", default="s2d")
    args = ap.parse_args()

    from bnn_pynq_tpu.runtime.engine import InferenceEngine
    from bnn_pynq_tpu.train import data as data_mod
    from bnn_pynq_tpu.utils.baseline import baseline_top1

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    artifact = args.artifact or os.path.join(root,
                                             DEFAULT_ARTIFACTS[args.dataset])
    ds = data_mod.load(args.dataset)

    report = {"dataset": args.dataset, "artifact": artifact,
              "synthetic_data": ds.synthetic}

    hw = InferenceEngine.from_artifact(artifact, runtime="device",
                                       route=args.route,
                                       batch_buckets=(args.batch,))
    acc, usec, n = evaluate(hw, ds, args.batch, args.limit)
    report["hw"] = {"runtime": "device", "top1": round(acc, 5),
                    "usec_per_image": round(usec, 2), "n": n}

    sw = InferenceEngine.from_artifact(artifact, runtime="ref",
                                       batch_buckets=(args.batch,))
    n_cmp = min(512, n)
    acc_sw, usec_sw, _ = evaluate(sw, ds, args.batch, n_cmp)
    report["sw_ref"] = {"runtime": "ref", "top1": round(acc_sw, 5),
                        "usec_per_image": round(usec_sw, 2), "n": n_cmp}

    # HW/SW twin check («bnn/bnn.py» RUNTIME_HW vs RUNTIME_SW): identical
    # predictions on the comparison slice
    xs = ds.x_test[:n_cmp]
    mismatch = int((hw.classify(xs) != sw.classify(xs)).sum())
    report["hw_vs_sw_mismatches"] = mismatch

    name = os.path.basename(artifact).rsplit(".", 1)[0]
    base = baseline_top1(name, args.dataset)
    if base is not None:
        report["reference_top1"] = base
    print(json.dumps(report, indent=2))
    if mismatch:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
