"""Inception-v3 streaming inference — BASELINE config 5, the port of
``examples/imagenet/inception_infer.py``.

Images stream from the driver through the nodes' feeds onto each node's
device in static padded batches (``bundle_inference_loop``); results come
back ordered, exactly one per image.

Run:  python inception_infer.py --num-executors 1 --images 64 --image-size 299 \\
          [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def export_random_bundle(export_dir: str, seed: int = 0) -> dict:
    """Export a randomly initialised Inception-v3 bundle (the stand-in for a
    trained checkpoint; the reference example downloaded a pretrained one):
    ``{"params", "batch_stats"}`` in the JAX package's layout.  Returns its
    model config."""
    import torch

    from tensorflowonspark_torch.checkpoint import export_bundle
    from tensorflowonspark_torch.convert import torch_to_flax
    from tensorflowonspark_torch.models import inception

    config = {"model": "inception_v3", "num_classes": 1001, "bf16": True}
    model = inception.build_inception_v3(config).init_weights(
        torch.Generator().manual_seed(seed))
    export_bundle(export_dir, torch_to_flax(model.state_dict(), config=config), config)
    return config


def main(argv=None) -> list:
    import tensorflowonspark_torch as tos
    from tensorflowonspark_torch.inference import bundle_inference_loop
    from tensorflowonspark_torch.models import inception

    p = argparse.ArgumentParser()
    p.add_argument("--num-executors", type=int, default=1)
    p.add_argument("--images", type=int, default=64)
    p.add_argument("--image-size", type=int, default=299)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--partitions", type=int, default=4)
    p.add_argument("--export-dir", default="")
    p.add_argument("--log-dir", default=os.path.join(tempfile.gettempdir(), "inception_logs"))
    p.add_argument("--device", default=None, help="each node's device (default cuda)")
    args = p.parse_args(argv)

    export_dir = args.export_dir or os.path.join(tempfile.gettempdir(), "inception_bundle")
    if not os.path.exists(os.path.join(export_dir, "bundle.json")):
        print("exporting random-init bundle to", export_dir)
        export_random_bundle(export_dir)

    images = inception.synthetic_images(args.images, args.image_size)
    data = tos.PartitionedDataset.from_iterable(images, args.partitions)
    cluster = tos.run(
        bundle_inference_loop,
        {"export_dir": export_dir, "batch_size": args.batch_size, "postprocess": "argmax",
         "device": args.device},
        num_executors=args.num_executors,
        input_mode=tos.InputMode.STREAMING,
        log_dir=args.log_dir,
    )
    try:
        preds = cluster.inference(data)
    finally:
        cluster.shutdown()
    if len(preds) != args.images:
        raise RuntimeError(f"{len(preds)} results for {args.images} images")
    print(f"scored {len(preds)} images; first 10 class ids: {preds[:10]}")
    return preds


if __name__ == "__main__":
    main()
