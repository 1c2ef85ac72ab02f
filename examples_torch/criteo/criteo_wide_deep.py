"""Criteo wide-and-deep through the ML pipeline — BASELINE config 4, the
port of ``examples/criteo/criteo_wide_deep.py`` (the reference ran
``TFEstimator.fit`` → ``TFModel.transform`` over Spark DataFrames).

End to end: rows → ``TorchEstimator.fit`` boots a real multi-process
cluster, streams partitions into each node's DataFeed, each node trains the
wide-and-deep CTR model on its own device with optax's Adagrad
(``tensorflowonspark_torch.optim.Adagrad``), the chief exports a bundle in
the JAX package's layout (``convert.torch_to_flax``, so the JAX package
loads it too) → ``TorchModel.transform`` scores a dataset
partition-by-partition (ordered, exactly-count) from the cached bundle.
The node's device is ``args["device"]`` (default ``cuda``).

By default generates synthetic Criteo-shaped rows; pass --data-tsv pointing
at real Criteo TSV (label \\t 13 ints \\t 26 hex cats) to use it.

  python criteo_wide_deep.py --num-executors 2 --epochs 2 [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def train_fn(args, ctx):
    """Runs on every node: stream rows, train, chief exports bundle."""
    import torch

    from tensorflowonspark_torch.checkpoint import export_bundle
    from tensorflowonspark_torch.convert import torch_to_flax
    from tensorflowonspark_torch.gpu_info import default_device
    from tensorflowonspark_torch.models import wide_deep
    from tensorflowonspark_torch.optim import Adagrad
    from tensorflowonspark_torch.parallel import dp as dplib

    config = {"model": "wide_deep",
              "vocab_size": int(args.get("vocab_size", 100_003)),
              "embed_dim": int(args.get("embed_dim", 16)),
              "hidden": (256, 128, 64),
              "bf16": bool(args.get("bf16", True))}
    device = default_device(args.get("device"))
    with torch.device(device):
        model = wide_deep.build_wide_deep(config)
    wide_deep.init_params(model, torch.Generator(device).manual_seed(0))
    optimizer = Adagrad(model.parameters(), float(args.get("lr", 0.01)))
    state = dplib.TrainState.create(model, optimizer)
    step_fn = dplib.make_train_step(wide_deep.make_loss_fn(model), optimizer)

    feed = ctx.get_data_feed(train_mode=True)
    batches = dplib.make_batch_iterator(
        feed, int(args.get("batch_size", 512)), wide_deep.batch_to_arrays,
        ctx=ctx, max_steps=args.get("steps"))
    step = loss = None
    for batch, _n in batches:
        state, metrics = step_fn(state, batch)
        step = state.step
        loss = float(metrics["loss"])
        if step % 50 == 0:
            print(f"node {ctx.executor_id} step {step}: loss={loss:.4f}")
    if ctx.executor_id == 0:
        export_bundle(args.export_dir,
                      torch_to_flax(model.state_dict(), config=config), config)
        print(f"chief exported bundle to {args.export_dir} "
              f"(final step {step}, loss {loss})")
    ctx.barrier("export")  # nobody exits before the bundle exists


def load_tsv(path: str):
    """Real Criteo TSV → row dicts matching wide_deep.batch_to_arrays."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            label = float(parts[0])
            numeric = [float(v) if v else 0.0 for v in parts[1:14]]
            cats = [int(v, 16) if v else 0 for v in parts[14:40]]
            rows.append({"features": numeric + cats, "label": label})
    return rows


def main(argv=None) -> dict:
    """Fit, then score the first 256 rows; returns ``{"scored": rows,
    "fit_s": ..., "transform_s": ...}`` (host-clock seconds)."""
    p = argparse.ArgumentParser()
    p.add_argument("--num-executors", type=int, default=2)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--rows", type=int, default=4096, help="synthetic row count")
    p.add_argument("--vocab-size", type=int, default=100_003)
    p.add_argument("--data-tsv", default="", help="real Criteo TSV path")
    p.add_argument("--device", default=None, help="each node's device (default cuda)")
    p.add_argument("--export-dir", default="/tmp/criteo_bundle")
    p.add_argument("--log-dir", default="/tmp/criteo_logs")
    args = p.parse_args(argv)

    from tensorflowonspark_torch import pipeline
    from tensorflowonspark_torch.cluster import InputMode
    from tensorflowonspark_torch.data import PartitionedDataset
    from tensorflowonspark_torch.models import wide_deep

    rows = (load_tsv(args.data_tsv) if args.data_tsv
            else wide_deep.synthetic_criteo(args.rows, seed=0))
    data = PartitionedDataset.from_iterable(rows, args.num_executors * 2)

    estimator = pipeline.TorchEstimator(
        train_fn,
        tf_args={"vocab_size": args.vocab_size, "lr": 0.01, "bf16": False,
                 "device": args.device},
        batch_size=args.batch_size,
        epochs=args.epochs,
        num_executors=args.num_executors,
        input_mode=InputMode.STREAMING,
        export_dir=args.export_dir,
        log_dir=args.log_dir,
    )
    t0 = time.perf_counter()
    model = estimator.fit(data)
    fit_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    scored = model.transform(PartitionedDataset.from_iterable(rows[:256], 4))
    out = list(scored)
    transform_s = time.perf_counter() - t0
    pos = sum(1 for r in out if r["prediction"] > 0.5)
    print(f"scored {len(out)} rows; {pos} predicted positive; "
          f"sample: {out[0]['prediction']:.4f} (label {rows[0]['label']}); "
          f"fit {fit_s:.1f} s, transform {transform_s:.1f} s (host clock)")
    return {"scored": out, "fit_s": fit_s, "transform_s": transform_s}


if __name__ == "__main__":
    main()
