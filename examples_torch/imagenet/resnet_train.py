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

``--fsdp > 1`` and ``--profile-dir`` are not ported yet and raise.
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
    if args.fsdp > 1:
        raise NotImplementedError(
            "--fsdp > 1 (sharded parameters) is not ported yet: ROADMAP.md "
            "queue 1 (e), the torch device mesh with MoE and parallel/*")
    if args.profile_dir:
        raise NotImplementedError(
            "--profile-dir is not ported yet: ROADMAP.md queue 1 (f), "
            "profiling.py on torch.profiler")

    import numpy as np
    import torch

    from tensorflowonspark_torch.checkpoint import CheckpointManager
    from tensorflowonspark_torch.gpu_info import default_device
    from tensorflowonspark_torch.models import resnet
    from tensorflowonspark_torch.parallel import dp as dplib

    device = default_device(args.device)
    print(f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    with torch.device(device):
        model = resnet.build_resnet50({"num_classes": args.num_classes, "bf16": True})
    model.init_weights(torch.Generator(device=device).manual_seed(0))
    optimizer = torch.optim.SGD(model.parameters(), lr=args.lr, momentum=0.9, nesterov=True)
    state = dplib.BNTrainState.create(model, optimizer)

    ckpt = CheckpointManager(args.model_dir) if args.model_dir else None
    if ckpt is not None:
        # the full train state: a restart resumes with momentum and the
        # step counter, not just the weights
        restored = ckpt.restore_latest(state.tree())
        if restored is not None:
            state = state.restore(restored[0])
            print(f"restored checkpoint at step {restored[1]}")

    step_fn = dplib.make_bn_train_step(resnet.make_loss_fn(model, weight_decay=1e-4), optimizer)

    if args.tfrecord_dir:
        from tensorflowonspark_torch import dfutil

        dataset, _ = dfutil.load_tfrecords(args.tfrecord_dir)
        shape = (args.image_size, args.image_size, 3)

        def batch_stream():
            rows = []
            while True:  # cycle the dataset forever
                for row in dataset:
                    rows.append(row)
                    if len(rows) == args.batch:
                        yield {"image": np.stack([np.asarray(r["image"], np.float32)
                                                  .reshape(shape) for r in rows]),
                               "label": np.asarray([r["label"] for r in rows], np.int32)}
                        rows = []

        batches = batch_stream()
    else:
        rng = np.random.RandomState(0)
        fixed = {
            "image": torch.from_numpy(rng.rand(args.batch, args.image_size, args.image_size, 3)
                                      .astype(np.float32)).to(device),
            "label": torch.from_numpy((np.arange(args.batch) % args.num_classes)
                                      .astype(np.int32)).to(device),
        }
        batches = iter(lambda: fixed, None)

    def one_step():
        nonlocal state
        state, m = step_fn(state, next(batches))
        return m

    metrics = one_step()  # warm-up (cuDNN's algorithm search): outside the timed window
    print(f"step 0: loss={float(metrics['loss']):.4f}")
    t0 = time.perf_counter()
    for _ in range(args.steps):
        metrics = one_step()
    loss = float(metrics["loss"])  # waits for the device
    dt = time.perf_counter() - t0
    imgs = args.batch * args.steps / dt
    print(f"step {args.steps}: loss={loss:.4f} ({imgs:,.0f} images/sec, {imgs:,.0f}/chip)")
    if ckpt is not None:
        ckpt.save(state.step, state.tree())
        ckpt.wait()
        print("checkpoint saved")
    return {"loss": loss, "images_per_sec": imgs, "step": state.step}


if __name__ == "__main__":
    main()
