"""Module-level map_funs for the port's cluster tests
(``tests/test_torch_cluster.py``, ``tests/test_torch_gateway.py``) — the
counterparts of ``tests/mapfuns.py`` that import only
``tensorflowonspark_torch``.

Kept importable (not closures) so they ship to spawned node processes by
reference, with or without ``cloudpickle``.
"""

from __future__ import annotations

import json
import os


def noop(args, ctx):
    """Register, do nothing, exit."""
    return None


def writes_role(args, ctx):
    out = os.path.join(args["out_dir"], f"role_{ctx.executor_id}.txt")
    with open(out, "w") as f:
        f.write(f"{ctx.job_name}:{ctx.task_index}:{ctx.num_executors}")


def sum_batches(args, ctx):
    """Drain the feed summing numbers; write the total to args['out_dir']."""
    feed = ctx.get_data_feed(train_mode=True)
    total = 0.0
    count = 0
    while not feed.should_stop():
        batch = feed.next_batch(args["batch_size"])
        total += sum(batch)
        count += len(batch)
    out = os.path.join(args["out_dir"], f"node_{ctx.executor_id}.txt")
    with open(out, "w") as f:
        f.write(f"{total} {count}")


def echo_inference(args, ctx):
    """Classic inference loop: read batches, emit one result per input item."""
    feed = ctx.get_data_feed(train_mode=False)
    while not feed.should_stop():
        batch = feed.next_batch(4)
        if batch:
            feed.batch_results([x * 2 for x in batch])


def early_terminator(args, ctx):
    """Consume a few items then terminate — exercises the fast-drain path."""
    feed = ctx.get_data_feed(train_mode=True)
    feed.next_batch(args["consume"])
    feed.terminate()


def failing(args, ctx):
    raise ValueError("intentional failure for error propagation test")


def all_reduce_ranks(args, ctx):
    """One ``torch.distributed`` all-reduce of ``rank + 1`` over the
    process group ``run(torch_distributed=True)`` formed; writes what the
    node saw to ``args['out_dir']``."""
    import torch
    import torch.distributed as dist

    from tensorflowonspark_torch import gpu_info

    t = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(t)
    out = os.path.join(args["out_dir"], f"dist_{ctx.executor_id}.json")
    with open(out, "w") as f:
        json.dump({"rank": dist.get_rank(), "world": dist.get_world_size(),
                   "backend": dist.get_backend(), "sum": t.item(),
                   "process_index": gpu_info.device_summary()["process_index"]},
                  f)


def elastic_sum_batches(args, ctx):
    """Restartable feed consumer for the port's elastic-recovery test, the
    counterpart of ``tests/mapfuns.py:elastic_sum_batches``.

    Appends every consumed item to a per-(executor, incarnation) coverage
    file (so the test can assert at-least-once delivery across a death), and
    — when ``args['model_dir']`` is set — checkpoints a step counter after
    every batch and resumes it via ``checkpoint.restore_for_restart`` on a
    supervised restart, reporting the resumed step through ``update_meta``.
    """
    manager = None
    step = 0
    if args.get("model_dir"):
        import numpy as np

        from tensorflowonspark_torch import checkpoint as tckpt

        model_dir = os.path.join(args["model_dir"], f"node_{ctx.executor_id}")
        manager = tckpt.CheckpointManager(model_dir, max_to_keep=2,
                                          async_save=False)
        restored = tckpt.restore_for_restart(ctx, manager)
        if restored is not None:
            step = int(restored[1])
    ctx.update_meta({"incarnation": ctx.incarnation,
                     f"resumed_step_inc{ctx.incarnation}": step})
    cover = os.path.join(
        args["out_dir"], f"seen_{ctx.executor_id}_inc{ctx.incarnation}.txt")
    feed = ctx.get_data_feed(train_mode=True)
    with open(cover, "a") as f:
        while not feed.should_stop():
            batch = feed.next_batch(args["batch_size"])
            if not batch:
                continue
            f.write("".join(f"{int(x)}\n" for x in batch))
            f.flush()
            step += 1
            if manager is not None:
                manager.save(step, {"step": np.asarray(step)})


def train_linear(args, ctx):
    """Train ``models/linear.py`` (``y = x @ w + b``) on ``(x, y)`` rows
    from the feed with SGD and momentum, resuming the full train state
    (weights, momentum, step) from the newest checkpoint in
    ``args['model_dir']`` and saving it at the end through ``chief_save`` —
    the shape of the JAX package's ``examples/mnist/mnist_dist.py:main_fun``
    that ``tests/test_mnist_e2e.py`` restarts."""
    import numpy as np
    import torch

    from tensorflowonspark_torch.checkpoint import CheckpointManager, chief_save
    from tensorflowonspark_torch.models.registry import build
    from tensorflowonspark_torch.parallel.dp import (TrainState, make_batch_iterator,
                                                     make_train_step)

    model = build({"model": "linear", "in_dim": 4, "out_dim": 1})
    with torch.no_grad():
        model.weight.fill_(1.0)
        model.bias.zero_()
    optimizer = torch.optim.SGD(model.parameters(), lr=args.get("lr", 0.05),
                                momentum=0.9)
    state = TrainState.create(model, optimizer)
    manager = CheckpointManager(args["model_dir"])
    restored = manager.restore_latest(state.tree())
    if restored is not None:
        state = state.restore(restored[0])

    def to_arrays(rows):
        return {"x": np.stack([np.asarray(x, np.float32) for x, _ in rows]),
                "y": np.asarray([[y] for _, y in rows], np.float32)}

    def loss_fn(model, batch):
        return torch.mean((model(batch["x"]) - batch["y"]) ** 2), {}

    step = make_train_step(loss_fn, optimizer)
    feed = ctx.get_data_feed(train_mode=True)
    for batch, _n in make_batch_iterator(feed, args.get("batch_size", 4), to_arrays,
                                         ctx=ctx):
        state, _ = step(state, batch)
    chief_save(ctx, manager, state.step, state.tree())
