"""Distributed MNIST, streaming input mode — BASELINE config 1, the port of
``examples/mnist/mnist_dist.py``.

The driver streams partitions of (image, label) samples into each node's
DataFeed; each node trains the MNIST CNN on its own device with SGD and
momentum, with the control-plane ``all_done`` consensus deciding when every
node stops.  As in the JAX example, a node trains on its own local devices
and the chief saves and exports: there is no gradient exchange between
nodes.  The node's device is ``args["device"]`` (default ``cuda``).

Run directly:  python mnist_dist.py --num-executors 2 --epochs 1 [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if _REPO not in sys.path:  # allow running straight from a checkout
    sys.path.insert(0, _REPO)


def _model_config(args) -> dict:
    return {"model": "mnist_cnn", "num_classes": 10, "bf16": bool(args.get("bf16")),
            "features": list(args.get("features", (32, 64))),
            "dense": args.get("dense", 256)}


def _evaluator_loop(args, ctx):
    """The evaluator role: a sidecar node that loads the newest checkpoint
    as the chief writes it, scores a held-out set and publishes the accuracy
    (``ctx.update_meta({"evals": ...})`` and eval scalars).  It takes no
    data and joins no training barrier; it exits once the chief's
    ``TRAINING_DONE`` marker is down and the last checkpoint is scored, or
    on a driver stop signal."""
    import numpy as np
    import torch

    from tensorflowonspark_torch.checkpoint import latest_step_dir, restore_checkpoint
    from tensorflowonspark_torch.gpu_info import default_device
    from tensorflowonspark_torch.models import mnist
    from tensorflowonspark_torch.summary import SummaryWriter
    from tensorflowonspark_torch.utils.paths import resolve_uri

    device = default_device(args.get("device"))
    with torch.device(device):
        model = mnist.build_mnist(_model_config(args)).eval()
    batch = mnist.batch_to_arrays(
        mnist.synthetic_mnist(args.get("eval_samples", 128), seed=args.get("eval_seed", 1)))
    images = torch.as_tensor(batch["image"], device=device)
    writer = (SummaryWriter(os.path.join(args["log_dir"], "eval"))
              if args.get("log_dir") else None)
    done_marker = os.path.join(resolve_uri(args["model_dir"]), "TRAINING_DONE")
    interval = float(args.get("eval_interval", 10.0))
    last_step, evals, fails = -1, [], 0
    try:
        while True:
            # the marker is read BEFORE the listing: a marker present when
            # the latest step was seen means no newer checkpoint can follow
            training_done = os.path.exists(done_marker)
            path = latest_step_dir(args["model_dir"])
            step_no = int(path.rsplit("_", 1)[1]) if path is not None else None
            if step_no is not None and step_no > last_step:
                try:
                    weights = restore_checkpoint(path)["model"]
                except Exception:  # noqa: BLE001 - the chief's keep-K GC may
                    # delete step_N while it is read; a newer step exists
                    # then.  Count the failures so an unreadable FINAL
                    # checkpoint is given up after a few polls.
                    weights = None
                    fails += 1
                if weights is not None:
                    fails = 0
                    model.load_state_dict(weights)
                    with torch.inference_mode():
                        preds = model(images).argmax(-1).cpu().numpy()
                    acc = float((preds == np.asarray(batch["label"])).mean())
                    if writer is not None:
                        writer.add_scalar("eval/accuracy", acc, step_no)
                    evals.append({"step": step_no, "accuracy": acc})
                    ctx.update_meta({"evals": evals})
                    last_step = step_no
            # training_done counts only once the NEWEST checkpoint is scored
            # (or retried past its bound)
            caught_up = step_no is None or last_step >= step_no or fails >= 3
            if (training_done and caught_up) or ctx.stop_requested.is_set():
                return
            ctx.stop_requested.wait(interval if fails == 0 else min(interval, 2.0))
    finally:
        if writer is not None:
            writer.close()


def main_fun(args, ctx):
    """map_fun executed on every node (reference signature: main_fun(args, ctx))."""
    import torch

    from tensorflowonspark_torch.checkpoint import CheckpointManager, chief_save, export_bundle
    from tensorflowonspark_torch.convert import torch_to_flax
    from tensorflowonspark_torch.gpu_info import default_device
    from tensorflowonspark_torch.models import mnist
    from tensorflowonspark_torch.parallel.dp import TrainState, make_batch_iterator, make_train_step
    from tensorflowonspark_torch.summary import SummaryWriter
    from tensorflowonspark_torch.utils.paths import resolve_uri

    # A restart into the same model_dir must not leave last run's
    # TRAINING_DONE marker behind (the evaluator would exit at once): the
    # chief clears it and EVERY node, evaluator included, waits on the
    # barrier, so the evaluator never sees a stale one.
    if args.get("model_dir"):
        if ctx.executor_id == 0:
            import contextlib

            os.makedirs(resolve_uri(args["model_dir"]), exist_ok=True)
            with contextlib.suppress(FileNotFoundError):
                os.remove(os.path.join(resolve_uri(args["model_dir"]), "TRAINING_DONE"))
        ctx.barrier("marker-clear", timeout=120.0)

    if ctx.job_name == "evaluator":
        return _evaluator_loop(args, ctx)

    device = default_device(args.get("device"))
    model_config = _model_config(args)
    with torch.device(device):
        model = mnist.build_mnist(model_config)
    model.init_weights(torch.Generator(device=device).manual_seed(args.get("seed", 0)))
    optimizer = torch.optim.SGD(model.parameters(), lr=args.get("lr", 0.05), momentum=0.9)
    state = TrainState.create(model, optimizer)
    manager = CheckpointManager(args["model_dir"]) if args.get("model_dir") else None
    # A whole-job restart resumes from the latest checkpoint's FULL train
    # state: momentum and the step counter survive it.
    if manager is not None:
        restored = manager.restore_latest(state.tree())
        if restored is not None:
            state = state.restore(restored[0])
    step = make_train_step(mnist.make_loss_fn(model), optimizer)

    is_chief = ctx.executor_id == 0
    writer = None
    if is_chief and args.get("log_dir"):
        writer = SummaryWriter(os.path.join(args["log_dir"], "train"))

    feed = ctx.get_data_feed(train_mode=True)
    last_metrics = {}
    ckpt_every = int(args.get("checkpoint_every", 0) or 0)
    for batch, _n in make_batch_iterator(
        feed, args.get("batch_size", 64), mnist.batch_to_arrays, ctx=ctx,
        max_steps=args.get("steps"),
    ):
        state, metrics = step(state, batch)
        step_no = state.step
        if writer and step_no % args.get("log_every", 10) == 0:
            writer.add_scalars({k: float(v) for k, v in metrics.items()}, step_no)
        # Periodic saves are chief-local and async, with no barrier: under
        # STREAMING feeds nodes step at different rates, so a mid-loop
        # collective would deadlock.  The coordinated chief_save below runs
        # after the all_done consensus, where every node is aligned.
        if manager is not None and is_chief and ckpt_every and step_no % ckpt_every == 0:
            manager.save(step_no, state.tree())
        last_metrics = metrics

    if manager is not None:
        chief_save(ctx, manager, state.step, state.tree())
        if is_chief:
            # committed AFTER the final save: the evaluator exits once it
            # has both seen this marker and scored the newest checkpoint
            open(os.path.join(resolve_uri(args["model_dir"]), "TRAINING_DONE"), "w").close()
    if is_chief:
        if args.get("export_dir"):
            export_bundle(args["export_dir"],
                          torch_to_flax(model.state_dict(), config=model_config)["params"],
                          model_config)
        if writer:
            for k, v in last_metrics.items():
                writer.add_scalar(f"final/{k}", float(v), state.step)
            writer.close()


def inference_fun(args, ctx):
    """Streaming inference map_fun: items in, predictions out — ordered,
    exactly one per item."""
    import functools

    from tensorflowonspark_torch.checkpoint import load_bundle_cached
    from tensorflowonspark_torch.models import mnist, registry

    params, _config, apply_fn = load_bundle_cached(
        args["export_dir"], functools.partial(registry.build_apply, device=args.get("device")))
    feed = ctx.get_data_feed(train_mode=False)
    while not feed.should_stop():
        items = feed.next_batch(args.get("batch_size", 64))
        if not items:
            continue
        batch = mnist.batch_to_arrays([(i, 0) if not isinstance(i, tuple) else i for i in items])
        preds = apply_fn(params, batch["image"]).argmax(-1).cpu().numpy()
        feed.batch_results([int(p) for p in preds[: len(items)]])


def main() -> None:
    import tensorflowonspark_torch as tos
    from tensorflowonspark_torch.models.mnist import synthetic_mnist

    p = argparse.ArgumentParser()
    p.add_argument("--num-executors", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--samples", type=int, default=2000)
    p.add_argument("--partitions", type=int, default=8)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--device", default=None, help="each node's device (default cuda)")
    p.add_argument("--model-dir", default="/tmp/mnist_model")
    p.add_argument("--export-dir", default="/tmp/mnist_export")
    p.add_argument("--log-dir", default="/tmp/mnist_logs")
    p.add_argument("--tensorboard", action="store_true")
    p.add_argument("--eval", action="store_true",
                   help="add an evaluator node that periodically scores the "
                        "latest checkpoint (one extra executor)")
    p.add_argument("--eval-interval", type=float, default=10.0)
    p.add_argument("--checkpoint-every", type=int, default=50)
    a = p.parse_args()

    args = {
        "batch_size": a.batch_size, "lr": a.lr, "model_dir": a.model_dir,
        "export_dir": a.export_dir, "log_dir": a.log_dir, "device": a.device,
        "eval_interval": a.eval_interval, "checkpoint_every": a.checkpoint_every,
    }
    data = tos.PartitionedDataset.from_iterable(synthetic_mnist(a.samples), a.partitions)
    cluster = tos.run(
        main_fun, args,
        num_executors=a.num_executors + (1 if a.eval else 0),
        eval_node=a.eval,
        input_mode=tos.InputMode.STREAMING, tensorboard=a.tensorboard,
        log_dir=a.log_dir,
    )
    cluster.train(data, num_epochs=a.epochs)
    cluster.shutdown()
    print(f"training done; model in {a.model_dir}, bundle in {a.export_dir}")


if __name__ == "__main__":
    main()
