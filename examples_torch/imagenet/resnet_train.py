"""ResNet-50 / ImageNet training on one device — BASELINE config 3, the
single-card path of ``examples/imagenet/resnet_train.py``.

bf16 compute over float32 master weights, bf16 BatchNorm outputs with
float32 statistics, SGD with Nesterov momentum 0.9 and L2 1e-4 on the
kernels.  One synthetic batch stays resident on the device by default (the
benchmark configuration); ``--tfrecord-dir`` trains on rows with ``image``
(float list, H*W*3) and ``label`` features read through ``dfutil``.

  python examples_torch/imagenet/resnet_train.py --steps 50 --batch 256
  python examples_torch/imagenet/resnet_train.py --device cpu --image-size 32 \\
      --batch 2 --steps 2 --num-classes 10

Over a ``torchrun`` world the mesh is ``dp=-1, fsdp=N`` (``--fsdp N``):
each parameter is split over ``fsdp`` on its largest divisible dim
(``tp.shard_model(rules=())``), the running statistics replicated, each
rank trains its rows of the global ``--batch`` with BatchNorm over the
global batch, and ``--model-dir`` saves collectively (every rank its
blocks) and restores each leaf to the live state's placement::

  torchrun --nproc-per-node 2 examples_torch/imagenet/resnet_train.py \\
      --device cpu --fsdp 2 --image-size 32 --batch 4 --steps 1 \\
      --num-classes 10 --model-dir /tmp/rn

``--profile-dir DIR`` traces the timed steps with ``torch.profiler``
(``profiling.profile_steps``) into a TensorBoard/Chrome trace under DIR.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--fsdp", type=int, default=1)
    p.add_argument("--model-dir", default="")
    p.add_argument("--tfrecord-dir", default="",
                   help="directory of ImageNet TFRecords (else synthetic)")
    p.add_argument("--profile-dir", default="")
    p.add_argument("--device", default=None, help="default cuda")
    args = p.parse_args(argv)

    import torch.distributed as dist

    formed = int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized()
    if formed:  # the torchrun world: gloo on the CPU, NCCL on the card
        dist.init_process_group("gloo" if args.device == "cpu" else "nccl")
    try:
        return _train(args)
    finally:
        if formed:
            dist.destroy_process_group()


def _train(args) -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist

    from tensorflowonspark_torch import profiling
    from tensorflowonspark_torch.checkpoint import CheckpointManager, has_shards
    from tensorflowonspark_torch.models import resnet
    from tensorflowonspark_torch.parallel import dp as dplib
    from tensorflowonspark_torch.parallel import mesh as meshlib
    from tensorflowonspark_torch.parallel import tp as tplib

    mesh = meshlib.make_mesh(args.device, dp=-1, fsdp=args.fsdp)
    device = meshlib.device_of(mesh)
    lead = not dist.is_initialized() or dist.get_rank() == 0
    if lead:
        print(f"mesh: {meshlib.spec(mesh)} on {device}"
              + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    with torch.device(device):
        model = resnet.build_resnet50({"num_classes": args.num_classes, "bf16": True})
    model.init_weights(torch.Generator(device=device).manual_seed(0))
    dplib.replicate(model, mesh)  # rank 0's weights; BatchNorm over the global batch
    if args.fsdp > 1:
        tplib.shard_model(model, mesh, rules=())
    optimizer = torch.optim.SGD(model.parameters(), lr=args.lr, momentum=0.9, nesterov=True)
    state = dplib.BNTrainState.create(model, optimizer)

    ckpt = CheckpointManager(args.model_dir) if args.model_dir else None
    if ckpt is not None:
        # the full train state: a restart resumes with momentum and the
        # step counter, not just the weights; every leaf goes back to the
        # placement the live state has (fsdp blocks stay blocks)
        restored = ckpt.restore_latest(state.tree())
        if restored is not None:
            state = state.restore(restored[0])
            if lead:
                print(f"restored checkpoint at step {restored[1]}")

    step_fn = dplib.make_bn_train_step(resnet.make_loss_fn(model, weight_decay=1e-4), optimizer,
                                       mesh=mesh)
    n_batch = meshlib.axis_size(mesh, "dp", "fsdp")
    if args.batch % n_batch:
        raise ValueError(f"--batch {args.batch} does not split over {n_batch} batch ranks")
    rows = args.batch // n_batch
    first = meshlib.axis_index(mesh, "dp", "fsdp") * rows

    if args.tfrecord_dir:
        from tensorflowonspark_torch import dfutil

        dataset, _ = dfutil.load_tfrecords(args.tfrecord_dir)
        shape = (args.image_size, args.image_size, 3)

        def batch_stream():
            batch = []
            while True:  # cycle the dataset forever
                for row in dataset:
                    batch.append(row)
                    if len(batch) == args.batch:
                        mine = batch[first:first + rows]  # this rank's rows
                        yield {"image": np.stack([np.asarray(r["image"], np.float32)
                                                  .reshape(shape) for r in mine]),
                               "label": np.asarray([r["label"] for r in mine], np.int32)}
                        batch = []

        batches = batch_stream()
    else:
        rng = np.random.RandomState(0)
        images = rng.rand(args.batch, args.image_size, args.image_size, 3).astype(np.float32)
        labels = (np.arange(args.batch) % args.num_classes).astype(np.int32)
        fixed = {"image": torch.from_numpy(images[first:first + rows]).to(device),
                 "label": torch.from_numpy(labels[first:first + rows]).to(device)}
        batches = iter(lambda: fixed, None)

    def one_step():
        nonlocal state
        state, m = step_fn(state, next(batches))
        return m

    metrics = one_step()  # warm-up (cuDNN's algorithm search): outside the timed window
    if lead:
        print(f"step 0: loss={float(metrics['loss']):.4f}")
    t0 = time.perf_counter()
    if args.profile_dir:
        metrics = profiling.profile_steps(args.profile_dir, one_step,
                                          warmup=0, steps=args.steps)
    else:
        for _ in range(args.steps):
            metrics = one_step()
    loss = float(metrics["loss"])  # waits for the device
    dt = time.perf_counter() - t0
    imgs = args.batch * args.steps / dt
    if lead:
        print(f"step {args.steps}: loss={loss:.4f} ({imgs:,.0f} images/sec, "
              f"{imgs / mesh.mesh.numel():,.0f}/chip)")
    if ckpt is not None:
        tree = state.tree()
        if has_shards(tree) or lead:  # sharded: every rank writes its blocks
            ckpt.save(state.step, tree)
            ckpt.wait()
        if dist.is_initialized():
            dist.barrier()
        if lead:
            print("checkpoint saved")
    return {"loss": loss, "images_per_sec": imgs, "step": state.step}


if __name__ == "__main__":
    main()
