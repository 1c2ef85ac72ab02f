"""Distributed CIFAR-10 ResNet training, direct input mode — the port of
``examples/cifar10/cifar10_train.py``.

Each node reads its TFRecord shards (strided by executor id) and trains a
CIFAR-size ResNet (bottleneck blocks, 3x3 stem) on its own device with the
BatchNorm train step and SGD with Nesterov momentum 0.9; the chief exports
a ``{"params", "batch_stats"}`` bundle the JAX package loads too.

Usage: python cifar10_train.py --prepare   # writes synthetic shards
       python cifar10_train.py --num-executors 2 --epochs 2 [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if _REPO not in sys.path:  # allow running straight from a checkout
    sys.path.insert(0, _REPO)

import numpy as np


def synthetic_cifar(n: int, seed: int = 0) -> list[tuple[np.ndarray, int]]:
    """Deterministic learnable synthetic CIFAR: class k brightens channel
    stripe k (the JAX example's, sample for sample)."""
    rng = np.random.RandomState(seed)
    samples = []
    for i in range(n):
        label = i % 10
        img = rng.rand(32, 32, 3).astype(np.float32) * 0.2
        img[label * 3 : label * 3 + 3, :, label % 3] += 1.0
        samples.append((img, label))
    return samples


def prepare_data(output_dir: str, samples: int = 2000, partitions: int = 8) -> None:
    """Write synthetic CIFAR TFRecord shards (uint8 image bytes, as real
    CIFAR/ImageNet TFRecords hold them)."""
    from tensorflowonspark_torch import dfutil
    from tensorflowonspark_torch.data import PartitionedDataset

    rows = [{"image_raw": (img * 255).astype(np.uint8).tobytes(), "label": label}
            for img, label in synthetic_cifar(samples)]
    dfutil.save_as_tfrecords(PartitionedDataset.from_iterable(rows, partitions), output_dir)


def batch_to_arrays(items: list) -> dict:
    """uint8 HWC bytes -> a float32 NHWC batch."""
    images = np.stack([
        np.frombuffer(raw, np.uint8).reshape(32, 32, 3).astype(np.float32) / 255.0
        for raw, _ in items])
    labels = np.asarray([l for _, l in items], np.int32)
    return {"image": images, "label": labels}


def main_fun(args, ctx):
    import torch

    from tensorflowonspark_torch import dfutil
    from tensorflowonspark_torch.checkpoint import export_bundle
    from tensorflowonspark_torch.convert import torch_to_flax
    from tensorflowonspark_torch.feeding import IteratorFeed
    from tensorflowonspark_torch.gpu_info import default_device
    from tensorflowonspark_torch.models import resnet
    from tensorflowonspark_torch.parallel import dp as dplib

    device = default_device(args.get("device"))
    model_config = {"model": "resnet_cifar", "num_classes": 10,
                    "depth_blocks": args.get("depth_blocks", 3),
                    "width": args.get("width", 16),
                    "bf16": bool(args.get("bf16", True))}
    with torch.device(device):
        model = resnet.build_resnet_cifar(model_config)
    model.init_weights(torch.Generator(device=device).manual_seed(0))
    optimizer = torch.optim.SGD(model.parameters(), lr=args.get("lr", 0.1),
                                momentum=0.9, nesterov=True)
    state = dplib.BNTrainState.create(model, optimizer)
    step = dplib.make_bn_train_step(resnet.make_loss_fn(model, weight_decay=1e-4), optimizer)

    my_shards = dfutil.shard_files(args["data_dir"])[ctx.executor_id :: ctx.num_data_nodes]
    schema = dfutil.read_schema(args["data_dir"])

    def samples():
        for _epoch in range(args.get("epochs", 1)):
            for shard in my_shards:
                for row in dfutil.read_shard(shard, schema, binary_features={"image_raw"}):
                    yield (row["image_raw"], int(row["label"]))

    feed = IteratorFeed(samples())
    last = {}
    for batch, _n in dplib.make_batch_iterator(
        feed, args.get("batch_size", 128), batch_to_arrays, ctx=ctx
    ):
        state, last = step(state, batch)

    if ctx.executor_id == 0:
        print(f"final: loss={float(last['loss']):.4f} "
              f"acc={float(last['accuracy']):.3f} step={state.step}")
        if args.get("export_dir"):
            export_bundle(args["export_dir"],
                          torch_to_flax(model.state_dict(), config=model_config),
                          model_config)


def main() -> None:
    import tensorflowonspark_torch as tos

    p = argparse.ArgumentParser()
    p.add_argument("--data-dir", default="/tmp/cifar10_tfr")
    p.add_argument("--export-dir", default="/tmp/cifar10_export")
    p.add_argument("--num-executors", type=int, default=2)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--depth-blocks", type=int, default=3,
                   help="n bottleneck blocks per stage (9n+2 layers)")
    p.add_argument("--device", default=None, help="each node's device (default cuda)")
    p.add_argument("--prepare", action="store_true", help="write synthetic shards first")
    a = p.parse_args()

    if a.prepare:
        prepare_data(a.data_dir)
        print(f"shards written to {a.data_dir}")
        return
    args = {"data_dir": a.data_dir, "export_dir": a.export_dir, "device": a.device,
            "epochs": a.epochs, "batch_size": a.batch_size,
            "depth_blocks": a.depth_blocks}
    cluster = tos.run(main_fun, args, num_executors=a.num_executors,
                      input_mode=tos.InputMode.DIRECT)
    cluster.shutdown(timeout=600)
    print(f"trained from {a.data_dir}; bundle in {a.export_dir}")


if __name__ == "__main__":
    main()
