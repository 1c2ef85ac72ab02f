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
