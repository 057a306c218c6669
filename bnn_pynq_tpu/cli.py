"""Command-line interface — the analogue of the reference's build/run
scripts (SURVEY.md C15 «make-hw.sh/make-sw.sh» and the notebook drivers):

    python -m bnn_pynq_tpu.cli train   cnv-w1a1 --epochs 50 --out artifacts/
    python -m bnn_pynq_tpu.cli compile checkpoints/cnv-w1a1.npz --out artifacts/
    python -m bnn_pynq_tpu.cli classify artifacts/cnv-w1a1.npz image.npy
    python -m bnn_pynq_tpu.cli bench   artifacts/cnv-w1a1.npz --batch 1024
    python -m bnn_pynq_tpu.cli info    [network]

Hardware builds (Vivado synthesis) have no analogue: jit compilation
replaces them and is kept in a persistent cache (utils/compile_cache.py).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def cmd_train(args):
    from bnn_pynq_tpu.compiler import compile_network, save_artifact
    from bnn_pynq_tpu.models import get_config
    from bnn_pynq_tpu.train.trainer import train

    cfg = get_config(args.network)
    ckpt = os.path.join(args.out, f"{cfg.name}-checkpoint.npz")
    result = train(cfg, epochs=args.epochs, batch_size=args.batch_size,
                   lr_start=args.lr, seed=args.seed, checkpoint_path=ckpt,
                   log_every=1)
    print(f"best val acc: {result.best_val_acc:.4f}")
    compiled = compile_network(cfg, result.params, result.batch_stats,
                               meta={"val_acc": result.best_val_acc})
    path = os.path.join(args.out, f"{cfg.name}.npz")
    save_artifact(path, compiled)
    print(f"artifact: {path}")


def cmd_compile(args):
    from bnn_pynq_tpu.compiler import compile_network, save_artifact
    from bnn_pynq_tpu.models import get_config
    from bnn_pynq_tpu.train.trainer import load_checkpoint

    params, stats, meta = load_checkpoint(args.checkpoint)
    name = args.network or str(meta.get("config", ""))
    cfg = get_config(name)
    compiled = compile_network(cfg, params, stats,
                               meta={k: v for k, v in meta.items()})
    out = args.out or os.path.join(
        os.path.dirname(args.checkpoint), f"{cfg.name}.npz")
    if os.path.isdir(out):
        out = os.path.join(out, f"{cfg.name}.npz")
    save_artifact(out, compiled)
    print(f"artifact: {out}")


def cmd_classify(args):
    from bnn_pynq_tpu.runtime.classifier import Classifier

    clf = Classifier.from_artifact(args.artifact, runtime=args.runtime,
                                   route=args.route)
    imgs = np.load(args.images)
    if imgs.ndim == 3:
        imgs = imgs[None]
    preds = clf.classify_images(imgs)
    for i, p in enumerate(preds):
        print(f"{i}: {int(p)} ({clf.class_name(p)})")
    print(f"usecPerImage: {clf.usecPerImage:.1f}")


def cmd_bench(args):
    from bnn_pynq_tpu.runtime.engine import InferenceEngine

    engine = InferenceEngine.from_artifact(
        args.artifact, runtime=args.runtime, route=args.route,
        batch_buckets=(args.batch,))
    cfg = engine.config
    rng = np.random.default_rng(0)
    shape = ((args.batch, int(np.prod(cfg.input_shape)))
             if cfg.input_kind == "bipolar"
             else (args.batch,) + cfg.input_shape)
    x = rng.integers(-2, 2, size=shape).astype(np.int8)
    # --classify times the device-argmax production op (serving path);
    # default times full logits materialization
    fn = engine._classify_fn() if args.classify else engine._fn
    import jax
    xd = jax.device_put(x)
    np.asarray(fn(engine.params, engine.out_scale, engine.out_bias, xd))
    t0 = time.perf_counter()
    outs = [fn(engine.params, engine.out_scale, engine.out_bias, xd)
            for _ in range(args.iters)]
    np.asarray(outs[-1])
    dt = (time.perf_counter() - t0) / args.iters
    print(json.dumps({
        "network": cfg.name, "batch": args.batch, "route": args.route,
        "path": "classify" if args.classify else "logits",
        "ms_per_batch": round(dt * 1e3, 3),
        "images_per_sec": round(args.batch / dt, 1),
        "usec_per_image": round(dt / args.batch * 1e6, 3),
    }))


def cmd_eval(args):
    """Test-set accuracy of an artifact. With --gate, compares against the
    reference table (BASELINE.md) and exits 1 on a real-data Δ>0.1%
    regression; synthetic data marks the gate 'skipped' (it proves the
    pipeline, not the model)."""
    from bnn_pynq_tpu.runtime.engine import InferenceEngine
    from bnn_pynq_tpu.train import data as data_mod
    from bnn_pynq_tpu.utils.baseline import gate

    engine = InferenceEngine.from_artifact(args.artifact,
                                           runtime=args.runtime,
                                           route=args.route)
    cfg = engine.config
    ds = data_mod.load(cfg.dataset)
    correct = total = 0
    bs = args.batch
    for i in range(0, len(ds.x_test), bs):
        xs, ys = ds.x_test[i:i + bs], ds.y_test[i:i + bs]
        correct += int((engine.classify(xs) == ys).sum())
        total += len(ys)
    top1 = correct / total
    out = {
        "network": cfg.name, "dataset": cfg.dataset,
        "synthetic_data": ds.synthetic,
        "top1_accuracy": round(top1, 5), "n_test": total,
    }
    failed = False
    if args.gate:
        passed, ref, delta = gate(cfg.name, cfg.dataset, top1)
        if ds.synthetic:
            out["gate"] = "skipped (synthetic data)"
        elif passed is None:
            out["gate"] = "skipped (no baseline for this network/dataset)"
        else:
            out["gate"] = "passed" if passed else "FAILED"
            out["baseline_top1"] = ref
            out["delta"] = round(delta, 5)
            failed = not passed
    print(json.dumps(out))
    if failed:
        raise SystemExit(1)


def cmd_ingest(args):
    """Convert raw dataset files (MNIST IDX / CIFAR-10 binary / SVHN .mat /
    GTSRB ppm) into the cached npz the loaders resolve."""
    from bnn_pynq_tpu.train.datasets_raw import ingest
    path = ingest(args.dataset, root=args.root, out_dir=args.out)
    print(f"wrote {path}")


GATE_WORKLOADS = (
    # (config name, dataset) — one row per BASELINE.md accuracy entry
    ("sfc-w1a1", "mnist"), ("lfc-w1a1", "mnist"), ("lfc-w1a2", "mnist"),
    ("cnv-w1a1", "cifar10"), ("cnv-w1a2", "cifar10"),
    ("cnv-w2a2", "cifar10"),
    ("cnv-w1a1-svhn", "svhn"), ("cnv-w2a2-svhn", "svhn"),
    ("cnv-w1a1-gtsrb", "gtsrb"), ("cnv-w2a2-gtsrb", "gtsrb"),
)


def cmd_gate_all(args):
    """One-command Δ≤0.1% gate over every BASELINE.md workload:
    ingest-if-present → train-or-load → eval --gate per row. With no real
    data it prints 'skipped' per row and exits 0; with any real dataset
    present it produces the Δ row unattended. See
    README 'Real datasets' for exactly which files to drop where."""
    from bnn_pynq_tpu.models import get_config
    from bnn_pynq_tpu.runtime.engine import InferenceEngine
    from bnn_pynq_tpu.train import data as data_mod
    from bnn_pynq_tpu.train.datasets_raw import ingest
    from bnn_pynq_tpu.utils.baseline import gate

    os.makedirs(args.artifacts, exist_ok=True)
    any_failed = False
    n_skipped = 0
    for net, dataset in GATE_WORKLOADS:
        row = {"network": net, "dataset": dataset}
        try:
            # 1. ingest raw files if present and no cached npz exists yet
            try:
                row["ingested"] = os.path.basename(ingest(dataset))
            except FileNotFoundError:
                pass
            ds = data_mod.load(dataset)
            if ds.synthetic:
                row["gate"] = "skipped (no real data)"
                n_skipped += 1
                print(json.dumps(row), flush=True)
                continue

            # 2. train-or-load a real-data artifact. pretrained/ demo
            # artifacts are synthetic-provenance — evaluating them on
            # real data would gate-fail meaninglessly, so they are NOT
            # used here.
            art = os.path.join(args.artifacts, f"{net}.npz")
            if not os.path.exists(art):
                if not args.train:
                    row["gate"] = ("skipped (real data present but no "
                                   f"trained artifact at {art}; rerun "
                                   "with --train)")
                    n_skipped += 1
                    print(json.dumps(row), flush=True)
                    continue
                from bnn_pynq_tpu.compiler import (compile_network,
                                                   save_artifact)
                from bnn_pynq_tpu.train.trainer import preset_for, train
                cfg = get_config(net)
                preset = preset_for(cfg)
                if args.epochs:
                    preset["epochs"] = args.epochs
                result = train(cfg, ds, seed=args.seed,
                               checkpoint_path=os.path.join(
                                   args.artifacts,
                                   f"{net}-checkpoint.npz"),
                               **preset)
                compiled = compile_network(
                    cfg, result.params, result.batch_stats,
                    meta={"val_acc": result.best_val_acc,
                          "data": "real", "dataset": dataset})
                save_artifact(art, compiled)
                row["trained"] = round(result.best_val_acc, 5)

            # 3. eval + gate
            engine = InferenceEngine.from_artifact(
                art, runtime=args.runtime, route=args.route)
            correct = total = 0
            for i in range(0, len(ds.x_test), args.batch):
                hi = min(i + args.batch, len(ds.x_test))
                xs, ys = ds.x_test[i:hi], ds.y_test[i:hi]
                correct += int((engine.classify(xs) == ys).sum())
                total += len(ys)
            top1 = correct / total
            passed, ref, delta = gate(net, dataset, top1)
            row.update(top1_accuracy=round(top1, 5), n_test=total,
                       baseline_top1=ref,
                       delta=None if delta is None else round(delta, 5),
                       gate="passed" if passed else "FAILED")
            any_failed |= not passed
        except Exception as e:  # noqa: BLE001 — keep gating other rows
            row["error"] = str(e)[:300]
            any_failed = True
        print(json.dumps(row), flush=True)
    print(json.dumps({"summary": f"skipped x{n_skipped}",
                      "failed": any_failed}), flush=True)
    if any_failed:
        raise SystemExit(1)


def cmd_reload(args):
    """Operator-side zero-downtime weight rollout (the reference's
    load_parameters contract over HTTP, SURVEY.md §3.2): ships the
    artifact bytes to a live `serve` host."""
    import urllib.request
    with open(args.artifact, "rb") as f:
        body = f.read()
    resp = urllib.request.urlopen(urllib.request.Request(
        args.url.rstrip("/") + "/reload", data=body), timeout=300)
    print(resp.read().decode())


def cmd_serve(args):
    from bnn_pynq_tpu.runtime.http_server import serve
    buckets = tuple(sorted(int(b) for b in args.buckets.split(",") if b)) \
        if args.buckets else None
    serve(args.artifact, host=args.host, port=args.port,
          runtime=args.runtime, route=args.route,
          max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
          batch_buckets=buckets, warmup=not args.no_warmup)


def cmd_info(args):
    from bnn_pynq_tpu.models import AVAILABLE_CONFIGS, get_config
    from bnn_pynq_tpu.models.network import make_plan

    if not args.network:
        for name in sorted(AVAILABLE_CONFIGS):
            print(name)
        return
    cfg = get_config(args.network)
    print(f"{cfg.name}: {cfg.scheme()}  input={cfg.input_shape} "
          f"({cfg.input_kind})  classes={cfg.num_classes}  "
          f"dataset={cfg.dataset}")
    for i, lp in enumerate(make_plan(cfg)):
        if lp.kind == "pool":
            print(f"  [{i}] pool {lp.window}x{lp.window}")
        else:
            print(f"  [{i}] {lp.kind} K={lp.k} N={lp.n}"
                  + (f" kernel={lp.kernel}" if lp.kernel else "")
                  + ("  (logits)" if lp.last else ""))


def main(argv=None):
    from bnn_pynq_tpu.runtime.engine import ROUTES, RUNTIMES

    p = argparse.ArgumentParser(prog="bnn_pynq_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train a network and emit an artifact")
    t.add_argument("network")
    t.add_argument("--epochs", type=int, default=100)
    t.add_argument("--batch-size", type=int, default=100)
    t.add_argument("--lr", type=float, default=1e-3)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--out", default="artifacts")
    t.set_defaults(fn=cmd_train)

    c = sub.add_parser("compile", help="compile a checkpoint to an artifact")
    c.add_argument("checkpoint")
    c.add_argument("--network", default=None)
    c.add_argument("--out", default=None)
    c.set_defaults(fn=cmd_compile)

    cl = sub.add_parser("classify", help="classify images (npy file)")
    cl.add_argument("artifact")
    cl.add_argument("images")
    cl.add_argument("--runtime", default="device", choices=RUNTIMES)
    cl.add_argument("--route", default="s2d", choices=ROUTES)
    cl.set_defaults(fn=cmd_classify)

    b = sub.add_parser("bench", help="throughput benchmark")
    b.add_argument("artifact")
    b.add_argument("--batch", type=int, default=1024)
    b.add_argument("--iters", type=int, default=20)
    b.add_argument("--runtime", default="device", choices=RUNTIMES)
    b.add_argument("--route", default="s2d", choices=ROUTES)
    b.add_argument("--classify", action="store_true",
                   help="time the device-argmax classify path")
    b.set_defaults(fn=cmd_bench)

    e = sub.add_parser("eval", help="test-set accuracy of an artifact")
    e.add_argument("artifact")
    e.add_argument("--batch", type=int, default=1024)
    e.add_argument("--runtime", default="device", choices=RUNTIMES)
    e.add_argument("--route", default="s2d", choices=ROUTES)
    e.add_argument("--gate", action="store_true",
                   help="fail (exit 1) if real-data accuracy drops >0.1% "
                        "below the reference table")
    e.set_defaults(fn=cmd_eval)

    g = sub.add_parser("ingest", help="convert raw dataset files to the "
                                      "cached npz format")
    g.add_argument("dataset", choices=["mnist", "cifar10", "svhn", "gtsrb"])
    g.add_argument("--root", default=None,
                   help="directory holding the raw files (default: the "
                        "data search dirs)")
    g.add_argument("--out", default=None)
    g.set_defaults(fn=cmd_ingest)

    ga = sub.add_parser("gate-all", help="ingest→train-or-load→gate every "
                                         "BASELINE workload")
    ga.add_argument("--artifacts", default="artifacts",
                    help="dir for real-data-trained artifacts")
    ga.add_argument("--train", action="store_true",
                    help="train missing artifacts on real data "
                         "(reference schedules; long)")
    ga.add_argument("--epochs", type=int, default=0,
                    help="override preset epoch counts (0 = preset)")
    ga.add_argument("--batch", type=int, default=1024)
    ga.add_argument("--seed", type=int, default=0)
    ga.add_argument("--runtime", default="device", choices=RUNTIMES)
    ga.add_argument("--route", default="s2d", choices=ROUTES)
    ga.set_defaults(fn=cmd_gate_all)

    s = sub.add_parser("serve", help="HTTP classification server")
    s.add_argument("artifact")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8476)
    s.add_argument("--runtime", default="device", choices=RUNTIMES)
    s.add_argument("--route", default="s2d", choices=ROUTES)
    s.add_argument("--max-batch", type=int, default=256)
    s.add_argument("--max-wait-ms", type=float, default=3.0)
    s.add_argument("--buckets", default="",
                   help="comma-separated batch buckets (granular buckets "
                   "bound low-load latency); default: the engine's "
                   "standard set capped at max-batch")
    s.add_argument("--no-warmup", action="store_true",
                   help="skip compiling every bucket before serving "
                   "(first requests then pay the jit compile)")
    s.set_defaults(fn=cmd_serve)

    r = sub.add_parser("reload", help="hot-swap parameters on a running "
                       "serve host (POST /reload; zero downtime)")
    r.add_argument("artifact", help="npz artifact to roll out")
    r.add_argument("--url", default="http://127.0.0.1:8476",
                   help="serving host base URL")
    r.set_defaults(fn=cmd_reload)

    i = sub.add_parser("info", help="list networks / show a network plan")
    i.add_argument("network", nargs="?")
    i.set_defaults(fn=cmd_info)

    args = p.parse_args(argv)
    from bnn_pynq_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
