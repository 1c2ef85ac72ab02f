"""Distributed MNIST, direct (framework-reads-files) input mode — BASELINE
config 2, the port of ``examples/mnist/mnist_tfr.py``.

Each node reads the TFRecord shards assigned to it (strided by executor id,
the shard ownership ``tf.data`` auto-sharding gave the reference) through
``dfutil`` and ``data.interleave``, trains the MNIST CNN on its own device
through an ``IteratorFeed``, and agrees on a global stop through the
control-plane consensus.  As in the JAX example, each node trains on its
own device and the chief exports; no gradients cross nodes.

Usage: python mnist_tfr.py --prepare [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if _REPO not in sys.path:  # allow running straight from a checkout
    sys.path.insert(0, _REPO)


def prepare_data(output_dir: str, samples: int = 2000, partitions: int = 8) -> None:
    """Write synthetic MNIST TFRecord shards (the stand-in for the
    reference's mnist_data_setup.py, which downloaded the real set)."""
    from tensorflowonspark_torch import dfutil
    from tensorflowonspark_torch.data import PartitionedDataset
    from tensorflowonspark_torch.models.mnist import synthetic_mnist

    rows = [{"image": img.ravel().tolist(), "label": label}
            for img, label in synthetic_mnist(samples)]
    dfutil.save_as_tfrecords(PartitionedDataset.from_iterable(rows, partitions), output_dir)


def main_fun(args, ctx):
    import numpy as np
    import torch

    from tensorflowonspark_torch import dfutil
    from tensorflowonspark_torch.checkpoint import export_bundle
    from tensorflowonspark_torch.convert import torch_to_flax
    from tensorflowonspark_torch.data import interleave
    from tensorflowonspark_torch.feeding import IteratorFeed
    from tensorflowonspark_torch.gpu_info import default_device
    from tensorflowonspark_torch.models import mnist
    from tensorflowonspark_torch.parallel.dp import TrainState, make_batch_iterator, make_train_step

    device = default_device(args.get("device"))
    model_config = {"model": "mnist_cnn", "num_classes": 10,
                    "features": list(args.get("features", (32, 64))),
                    "dense": args.get("dense", 256)}
    with torch.device(device):
        model = mnist.build_mnist(model_config)
    model.init_weights(torch.Generator(device=device).manual_seed(args.get("seed", 0)))
    optimizer = torch.optim.SGD(model.parameters(), lr=args.get("lr", 0.05), momentum=0.9)
    state = TrainState.create(model, optimizer)
    step = make_train_step(mnist.make_loss_fn(model), optimizer)

    my_shards = dfutil.shard_files(args["data_dir"])[ctx.executor_id :: ctx.num_data_nodes]
    schema = dfutil.read_schema(args["data_dir"])
    readers = int(args.get("readers", 1) or 1)

    def shard_reader(shard):
        def it():
            for row in dfutil.read_shard(shard, schema):
                yield (np.asarray(row["image"], np.float32).reshape(28, 28, 1),
                       int(row["label"]))
        return it

    def samples():
        # `readers` background threads overlap shard reads and decoding
        # with the train step (the tf.data parallel-interleave analogue)
        for _epoch in range(args.get("epochs", 1)):
            yield from interleave([shard_reader(s) for s in my_shards], readers)

    feed = IteratorFeed(samples())
    for batch, _n in make_batch_iterator(
        feed, args.get("batch_size", 64), mnist.batch_to_arrays, ctx=ctx,
        max_steps=args.get("steps"),
    ):
        state, _metrics = step(state, batch)

    if ctx.executor_id == 0 and args.get("export_dir"):
        export_bundle(args["export_dir"],
                      torch_to_flax(model.state_dict(), config=model_config)["params"],
                      model_config)


def main() -> None:
    import tensorflowonspark_torch as tos

    p = argparse.ArgumentParser()
    p.add_argument("--data-dir", default="/tmp/mnist_tfr")
    p.add_argument("--export-dir", default="/tmp/mnist_export")
    p.add_argument("--num-executors", type=int, default=2)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--device", default=None, help="each node's device (default cuda)")
    p.add_argument("--prepare", action="store_true", help="write synthetic shards first")
    a = p.parse_args()

    if a.prepare:
        prepare_data(a.data_dir)
    args = {"data_dir": a.data_dir, "export_dir": a.export_dir, "device": a.device,
            "epochs": a.epochs, "batch_size": a.batch_size}
    cluster = tos.run(main_fun, args, num_executors=a.num_executors,
                      input_mode=tos.InputMode.DIRECT)
    cluster.shutdown(timeout=600)
    print(f"trained from {a.data_dir}; bundle in {a.export_dir}")


if __name__ == "__main__":
    main()
