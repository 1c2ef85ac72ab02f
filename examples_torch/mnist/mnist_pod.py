"""Multi-host (pod) MNIST: streaming feed + one global data-parallel step —
the port of ``examples/mnist/mnist_pod.py``.

The reference's defining deployment — Spark-streamed partitions feeding a
multi-worker synchronized TF cluster (``InputMode.SPARK`` +
``TF_CONFIG``/MWMS wiring, ``TFSparkNode.py:~260-300``/``:~430-510``) — as
one ``torch.distributed`` job: ``GPUPodLauncher`` places one node process
per (host, card slice), the driver streams DISJOINT partitions to each
node's feed, and every rank's batch is its share of ONE global batch
(``make_batch_iterator(mesh=)``): the train step sums the gradients over
the ranks (``make_train_step(mesh=)``), so every rank applies the update of
the concatenated batch.  Checkpoints are collective
(``checkpoint.chief_save``: executor 0 writes, the data nodes barrier).

Each node publishes what it did as ``ctx.update_meta({"mnist_pod": ...})``
(its rank, world size, backend, the ``CUDA_VISIBLE_DEVICES`` it saw, rows
trained, the step count, the seconds its step loop took, the losses and
this process's attention-kernel launches, which this CNN makes none of),
read from the driver through ``cluster.cluster_info``.  With ``args["export_dir"]`` the chief also
exports the final weights as a serving bundle.

Local demo (2 "hosts" on this machine, CPU ranks over gloo):

    python mnist_pod.py --hosts localhost,localhost --transport local \\
        --device cpu

One card per process on one GPU host: ``--hosts localhost,localhost
--transport local --gpu-slices 0:1``.  Real pod: ``--hosts gpu-0,gpu-1``
(passwordless ssh; the package must be importable on each host).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def model_config(args) -> dict:
    return {"model": "mnist_cnn", "num_classes": 10,
            "features": list(args.get("features", (32, 64))),
            "dense": args.get("dense", 256)}


def main_fun(args, ctx):
    import torch
    import torch.distributed as dist

    from tensorflowonspark_torch.checkpoint import CheckpointManager, chief_save, export_bundle
    from tensorflowonspark_torch.convert import torch_to_flax
    from tensorflowonspark_torch.models import mnist
    from tensorflowonspark_torch.ops import attention
    from tensorflowonspark_torch.parallel.dp import (
        TrainState, make_batch_iterator, make_train_step, replicate,
    )

    config = model_config(args)
    # The mesh spans EVERY rank of the pod's world (run by the launcher
    # with torch_distributed); each rank holds its own card (cuda:0 of its
    # slice) or, with device="cpu", the CPU.
    mesh = ctx.make_mesh(args.get("device"), dp=-1)
    dev = mesh.tos_device
    with torch.device(dev):
        model = mnist.build_mnist(config)
    model.init_weights(torch.Generator(device=dev).manual_seed(args.get("seed", 0)))
    replicate(model, mesh)  # rank 0's weights on every rank
    optimizer = torch.optim.SGD(model.parameters(), lr=args.get("lr", 0.05), momentum=0.9)
    state = TrainState.create(model, optimizer)
    manager = CheckpointManager(args["model_dir"]) if args.get("model_dir") else None
    if manager is not None:
        restored = manager.restore_latest(state.tree())
        if restored is not None:
            state = state.restore(restored[0])
    step = make_train_step(mnist.make_loss_fn(model), optimizer, mesh=mesh)

    feed = ctx.get_data_feed(train_mode=True)
    losses, rows = [], 0
    t0 = time.perf_counter()
    for batch, n in make_batch_iterator(
            feed, args.get("batch_size", 64), mnist.batch_to_arrays, mesh, ctx,
            max_steps=args.get("steps")):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"])
        rows += n
        if ctx.executor_id == 0 and state.step % args.get("log_every", 10) == 0:
            print(f"[global step {state.step}] "
                  f"loss={float(metrics['loss']):.4f} "
                  f"acc={float(metrics['accuracy']):.3f}", flush=True)
    losses = [float(x) for x in losses]  # waits for the last step
    train_s = time.perf_counter() - t0
    if manager is not None:
        # collective save: executor 0 writes, every data node barriers
        chief_save(ctx, manager, state.step, state.tree())
    if ctx.executor_id == 0 and args.get("export_dir"):
        export_bundle(args["export_dir"],
                      torch_to_flax(model.state_dict(), config=config)["params"], config)
    ctx.update_meta({"mnist_pod": {
        "rank": dist.get_rank(), "world": dist.get_world_size(),
        "backend": dist.get_backend(), "device": str(dev),
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "rows": rows, "steps": state.step, "train_s": train_s, "losses": losses,
        "attention_launches": dict(attention.LAUNCHES)}})


def main(argv=None) -> None:
    import tensorflowonspark_torch as tos
    from tensorflowonspark_torch.launcher import GPUPodLauncher
    from tensorflowonspark_torch.models.mnist import synthetic_mnist

    p = argparse.ArgumentParser()
    p.add_argument("--hosts", required=True,
                   help="comma-separated pod host names (one node per entry)")
    p.add_argument("--transport", default="ssh", choices=["ssh", "local"])
    p.add_argument("--gpu-slices", default=None,
                   help="each node's card ids on its host, ':'-separated per "
                        "node, ','-separated within one (e.g. 0:1 for two "
                        "nodes of one card each)")
    p.add_argument("--device", default=None,
                   help="each node's device (default cuda; cpu for a gloo world)")
    p.add_argument("--batch-size", type=int, default=64,
                   help="PER-HOST batch; the global batch is hosts x this")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--samples", type=int, default=2000)
    p.add_argument("--partitions", type=int, default=8)
    p.add_argument("--model-dir", default="/tmp/mnist_pod_model")
    p.add_argument("--log-dir", default="/tmp/mnist_pod_logs")
    a = p.parse_args(argv)

    hosts = a.hosts.split(",")
    slices = ([[int(c) for c in s.split(",")] for s in a.gpu_slices.split(":")]
              if a.gpu_slices else None)
    cpu = str(a.device or "cuda").startswith("cpu")
    pod = GPUPodLauncher(hosts=hosts, transport=a.transport, gpu_slices=slices,
                         platform="cpu" if cpu else "gpu")
    cluster = tos.run(
        main_fun,
        {"batch_size": a.batch_size, "model_dir": a.model_dir, "device": a.device},
        num_executors=len(hosts),
        input_mode=tos.InputMode.STREAMING,
        launcher=pod,                      # forces torch_distributed
        log_dir=a.log_dir,
    )
    data = tos.PartitionedDataset.from_iterable(
        synthetic_mnist(a.samples), a.partitions)
    cluster.train(data, num_epochs=a.epochs)
    cluster.shutdown()
    print(f"pod training done; checkpoints in {a.model_dir}")


if __name__ == "__main__":
    main()
