"""Module-level map_funs for the port's cluster tests
(``tests/test_torch_cluster.py``, ``tests/test_torch_gateway.py``,
``tests/test_torch_collective.py``, ``tests/test_torch_embedding.py``,
``tests/test_torch_pipeline.py``) and ``chip_smoke.py``'s config-4 phases —
the counterparts of ``tests/mapfuns.py`` that import only
``tensorflowonspark_torch``.

Kept importable (not closures) so they ship to spawned node processes by
reference, with or without ``cloudpickle``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time


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


def pod_probe(args, ctx):
    """A pod member's view, the counterpart of ``tests/test_distributed.py``'s
    ``_dist_map_fun_check_env``: the env values ``args['expect_env']``
    names arrived as sent (through the ssh transport's quoting), then one
    all-reduce of ``rank + 1`` over the world the pod formed; published as
    ``ctx.update_meta({"dist_check": ...})``."""
    import torch
    import torch.distributed as dist

    for key, want in (args or {}).get("expect_env", {}).items():
        got = os.environ.get(key)
        assert got == want, f"env {key!r}: {got!r} != {want!r}"
    t = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(t)
    ctx.update_meta({"dist_check": {
        "rank": dist.get_rank(), "world": dist.get_world_size(),
        "backend": dist.get_backend(), "sum": t.item(),
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")}})
    ctx.barrier("dist-done", timeout=120.0)


class _RecordingFeed:
    """A ``DataFeed`` that keeps every batch it hands out."""

    def __init__(self, feed):
        self._feed = feed
        self.batches: list = []

    def next_batch(self, n):
        items = self._feed.next_batch(n)
        if items:
            self.batches.append(items)
        return items

    def __getattr__(self, name):
        return getattr(self._feed, name)


def mnist_pod_recorded(args, ctx):
    """``examples_torch/mnist/mnist_pod.py:main_fun`` with the node's feed
    recorded: the first ``args['record']`` batches it handed out go to
    ``<out_dir>/batches_<executor_id>.npz`` (images and labels), so a test
    can replay the global batches in one process."""
    import numpy as np

    from examples_torch.mnist import mnist_pod

    feeds = []
    get_feed = ctx.get_data_feed

    def recording(*a, **kw):
        feeds.append(_RecordingFeed(get_feed(*a, **kw)))
        return feeds[-1]

    ctx.get_data_feed = recording
    mnist_pod.main_fun(args, ctx)
    batches = feeds[0].batches[:args["record"]]
    np.savez(os.path.join(args["out_dir"], f"batches_{ctx.executor_id}.npz"),
             **{f"image{i}": np.stack([img for img, _ in b]) for i, b in enumerate(batches)},
             **{f"label{i}": np.asarray([lab for _, lab in b]) for i, b in enumerate(batches)})


def train_streaming_dist_ckpt(args, ctx):
    """The counterpart of ``tests/mapfuns.py:train_streaming_dist_ckpt``:
    linear regression (``w`` of 4x1 at 0.5, SGD 0.1) over a ``dp`` mesh of
    the ``torch_distributed`` world, restore-or-init at start, the
    collective ``chief_save`` at the end.  Publishes the batches it trained
    on, so a test can replay the global steps.  The evaluator stays out of
    the process group and records that."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tensorflowonspark_torch.checkpoint import CheckpointManager, chief_save
    from tensorflowonspark_torch.parallel import dp as dplib

    if ctx.job_name == "evaluator":
        ctx.update_meta({"eval_process_count":
                         dist.get_world_size() if dist.is_initialized() else 1})
        return
    mesh = ctx.make_mesh("cpu", dp=-1)
    model = torch.nn.Module()
    model.w = torch.nn.Parameter(torch.full((4, 1), 0.5))
    dplib.replicate(model, mesh)
    optimizer = torch.optim.SGD(model.parameters(), lr=0.1)
    manager = CheckpointManager(args["model_dir"])
    state = dplib.TrainState.create(model, optimizer)
    restored = manager.restore_latest(state.tree())
    if restored is not None:
        state = state.restore(restored[0])

    def loss_fn(model, batch):
        pred = batch["x"] @ model.w
        return ((pred[:, 0] - batch["y"]) ** 2).mean(), {}

    step = dplib.make_train_step(loss_fn, optimizer, mesh=mesh)

    def to_arrays(items):
        return {"x": np.stack([np.asarray(i[0], np.float32) for i in items]),
                "y": np.asarray([i[1] for i in items], np.float32)}

    feed = ctx.get_data_feed(train_mode=True)
    losses, batches = [], []
    for batch, _n in dplib.make_batch_iterator(
            feed, int(args["batch_size"]), to_arrays, mesh=mesh, ctx=ctx):
        batches.append({k: torch.as_tensor(v).tolist() for k, v in batch.items()})
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    chief_save(ctx, manager, state.step, state.tree())
    ctx.update_meta({"ckpt_dist": {
        "losses": losses, "final_step": state.step,
        "world": dist.get_world_size(), "batches": batches,
        "final_w": model.w.detach().ravel().tolist()}})


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


def train_wide_deep(args, ctx):
    """Pipeline-style train_fn (``tests/mapfuns.py:train_wide_deep``): stream
    rows, train the wide-and-deep model on the node's device, the chief
    exports a bundle in the JAX layout.

    ``args`` is a ``pipeline.Namespace`` carrying export_dir/batch_size/
    epochs plus test knobs (vocab_size, device)."""
    import torch

    from tensorflowonspark_torch.checkpoint import export_bundle
    from tensorflowonspark_torch.convert import torch_to_flax
    from tensorflowonspark_torch.gpu_info import default_device
    from tensorflowonspark_torch.models import wide_deep
    from tensorflowonspark_torch.parallel import dp as dplib

    # model_config wins; vocab_size rides as a bare test knob otherwise —
    # never the module's full-width default
    config = dict(args.get("model_config") or
                  {"model": "wide_deep",
                   "vocab_size": args.get("vocab_size", 1009),
                   "embed_dim": 4, "hidden": (16, 8), "bf16": False})
    device = default_device(args.get("device"))
    model = wide_deep.build_wide_deep(config)
    wide_deep.init_params(model, torch.Generator().manual_seed(0))
    model.to(device)
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-2)
    state = dplib.TrainState.create(model, optimizer)
    step_fn = dplib.make_train_step(wide_deep.make_loss_fn(model), optimizer)

    feed = ctx.get_data_feed(train_mode=True)
    batches = dplib.make_batch_iterator(
        feed, int(args.get("batch_size", 16)), wide_deep.batch_to_arrays,
        ctx=ctx, max_steps=args.get("steps"))
    loss = None
    n_steps = 0
    for batch, _n in batches:
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        n_steps += 1
    ctx.update_meta({"train_steps": n_steps})
    if ctx.executor_id == 0:
        export_bundle(args.export_dir,
                      torch_to_flax(model.state_dict(), config=config), config)
    ctx.barrier("export")  # everyone waits for the bundle before exiting
    if loss is not None:
        with open(os.path.join(args.log_dir, f"loss_{ctx.executor_id}.txt"), "w") as f:
            f.write(str(loss))


# -- cross-host collectives ----------------------------------------------------


def collective_ops_probe(args, ctx):
    """Form a collective group and run every primitive once with exact
    integer-valued payloads; publish the results for driver-side equality
    checks (ring and naive must both produce the exact sums)."""
    import numpy as np

    group = ctx.collective_group(name="probe")
    group.form()
    r, w = group.rank, group.world
    base = np.arange(6, dtype=np.float32).reshape(2, 3) + float(r + 1)
    ring = group.all_reduce(base, algo="ring")
    naive = group.all_reduce(base, algo="naive")
    mean = group.all_reduce(base, average=True, algo="ring")
    bc = group.broadcast(np.full(5, 8.0, np.float32) if r == 1 else None,
                         root=1)
    gathered = group.all_gather(np.full(2 + r, float(r), np.float32))
    seg_idx, seg = group.reduce_scatter(
        np.arange(8, dtype=np.float32) * (r + 1))
    group.barrier()
    ctx.update_meta({"probe": {
        "rank": r, "world": w, "generation": group.generation,
        "ring": ring.tolist(), "naive": naive.tolist(),
        "mean": mean.tolist(), "bcast": bc.tolist(),
        "gathered": [g.tolist() for g in gathered],
        "seg_idx": int(seg_idx), "seg": seg.tolist(),
    }})
    group.close()


def _linear_state(w0: float, bias: bool, lr: float, device="cpu"):
    """``y = x @ w (+ b)`` as ``models/linear.py`` with ``w`` filled with
    ``w0`` (and ``b`` zero), and plain SGD (``optax.sgd``)."""
    import torch

    from tensorflowonspark_torch.models.linear import build_linear
    from tensorflowonspark_torch.parallel import dp as dplib

    model = build_linear({"in_dim": 3, "out_dim": 1}).to(device)
    with torch.no_grad():
        model.weight.fill_(w0)
        model.bias.zero_()
    model.bias.requires_grad_(bias)
    opt = torch.optim.SGD([p for p in model.parameters() if p.requires_grad], lr=lr)
    return dplib.TrainState.create(model, opt)


def _mse(model, batch):
    import torch

    err = model(batch["x"])[:, 0] - batch["y"]
    return torch.mean(err * err), {}


def train_sync_collective(args, ctx):
    """Feed-driven cross-host synchronous training (``mode="sync"``): each
    node drains its own streamed partitions in lockstep and the gradient
    dict mean-reduces across hosts each step through the group's bucketed
    ring all-reduce (``tests/mapfuns.py:train_sync_collective``)."""
    import numpy as np

    from tensorflowonspark_torch.gpu_info import default_device
    from tensorflowonspark_torch.parallel import dp as dplib

    state = _linear_state(0.5, True, 0.1, default_device(args.get("device")))
    group = ctx.collective_group()
    group.form()
    train = dplib.make_train_step(_mse, state.optimizer,
                                  cross_host_grad_fn=group.grad_fn())

    def to_arrays(items):
        return {"x": np.stack([np.asarray(i[0], np.float32) for i in items]),
                "y": np.asarray([i[1] for i in items], np.float32)}

    feed = ctx.get_data_feed(train_mode=True)
    losses = []
    for batch, _n in dplib.make_batch_iterator(
            feed, int(args["batch_size"]), to_arrays, ctx=ctx,
            lockstep=True):
        state, metrics = train(state, batch)
        losses.append(float(metrics["loss"]))
    group.barrier()
    ctx.update_meta({"sync_train": {
        "rank": group.rank, "world": group.world, "losses": losses,
        "final_w": state.model.weight.detach().cpu().numpy().ravel().tolist(),
        "final_b": float(state.model.bias.detach().cpu()[0]),
        "steps": int(state.step),
        "grad_device": str(state.model.weight.grad.device),
        "manifest_mode": ctx.job_manifest().get("mode"),
        "manifest_sync": ctx.job_manifest().get("sync"),
    }})
    group.close()


def chaos_batch(rank, step, batch_size=8):
    """Deterministic per-(rank, step) linear-regression batch with small
    integer-valued floats, so the chaos test's fault-free reference can be
    recomputed exactly in the driver."""
    import numpy as np

    base = np.arange(batch_size * 3, dtype=np.float32).reshape(batch_size, 3)
    x = (base * (1.0 + rank) + step) % 5.0
    y = (np.arange(batch_size, dtype=np.float32) + rank) % 3.0
    return {"x": x.astype(np.float32), "y": y.astype(np.float32)}


def sync_collective_chaos(args, ctx):
    """Fixed-step synchronous training on self-generated deterministic
    data, surviving a SIGKILL mid-all-reduce: survivors abort the poisoned
    round at the generation barrier, the supervised restart rejoins via
    ``reform`` + ``sync_state`` (the train state broadcast from the
    highest-step survivor), and every node finishes at EXACTLY
    ``args['steps']`` with identical params
    (``tests/mapfuns.py:sync_collective_chaos``)."""
    from tensorflowonspark_torch.collective import CollectiveAborted
    from tensorflowonspark_torch.parallel import dp as dplib

    total = int(args["steps"])
    # the state exists before the generation barrier: set-up between the
    # barrier and the first round reads as a straggler to the peers
    state = _linear_state(0.25, False, 0.125)
    group = ctx.collective_group(name="chaos")
    step = group.form(resume_step=0)
    state, step = group.sync_state(state, step)
    train = dplib.make_train_step(_mse, state.optimizer,
                                  cross_host_grad_fn=group.grad_fn())
    reforms = 0
    while step < total:
        batch = chaos_batch(group.rank, step)
        try:
            state, _metrics = train(state, batch)  # victim's kill fires inside
        except CollectiveAborted:
            group.reform(resume_step=step)
            state, step = group.sync_state(state, step)
            reforms += 1
            continue
        step += 1
    group.barrier()
    ctx.update_meta({"chaos_sync": {
        "rank": group.rank, "steps": step, "reforms": reforms,
        "generation": group.generation, "incarnation": ctx.incarnation,
        "final_w": state.model.weight.detach().numpy().ravel().tolist(),
    }})
    group.close()


# -- sharded embeddings --------------------------------------------------------


def tree_digest(tree) -> str:
    """Order-pinned sha256 of a param tree (flattened, keys sorted) — the
    bit-for-bit comparison handle the sharded-vs-unsharded parity tests
    exchange through update_meta instead of whole tables."""
    import hashlib

    import numpy as np

    from tensorflowonspark_torch.checkpoint import _flatten_tree

    h = hashlib.sha256()
    flat = _flatten_tree(tree)
    for key in sorted(flat):
        h.update(key.encode())
        arr = np.ascontiguousarray(np.asarray(flat[key]))
        h.update(str(arr.dtype).encode() + str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def dense_digest(model, config) -> str:
    """``tree_digest`` of a torch model's parameters in the JAX layout."""
    from tensorflowonspark_torch.convert import torch_to_flax

    return tree_digest(torch_to_flax(model.state_dict(), config=config))


def criteo_batch(rank, step, batch_size=8):
    """Deterministic per-(rank, step) synthetic-Criteo batch, so sharded
    parity/chaos references can replay the exact per-node schedule."""
    from tensorflowonspark_torch.models import wide_deep

    rows = wide_deep.synthetic_criteo(batch_size, seed=rank * 10007 + step)
    return wide_deep.batch_to_arrays(rows)


def embedding_probe(args, ctx):
    """Sparse-collective probe: exact-sum with duplicate ids within AND
    across nodes, the empty-partition edge (one owner receives nothing),
    a sparse all-to-all echo, and dense/sparse parity on a small table.
    Publishes everything for driver-side equality checks."""
    import numpy as np

    from tensorflowonspark_torch.embedding import ShardPlan

    group = ctx.collective_group(name="embprobe")
    group.form()
    r, w = group.rank, group.world
    plan = ShardPlan.even("probe", 40, 3, w)

    # all-to-all echo: rank r sends [r*100 + d] to each d
    parts = [(np.array([r * 100 + d], np.int64), None) for d in range(w)]
    echo = group.sparse_all_to_all(parts)
    echo_ids = [g[0].tolist() for g in echo]

    # exact-sum: duplicate id 1 within each node and across all nodes,
    # plus a per-rank id — integer-valued floats, so sums are exact
    ids = np.array([1, 1, 30 + r, 7], np.int64)
    rows = np.full((4, 3), float(r + 1), np.float32)
    got_ids, got_rows = group.sparse_reduce_scatter(ids, rows, plan.bounds)

    # dense parity: the same contribution as a dense [total, dim] gradient
    # all-reduced — the sparse result must match the dense sum row for row
    dense = np.zeros((40, 3), np.float32)
    np.add.at(dense, ids, rows)
    dense_sum = group.all_reduce(dense)
    lo, hi = plan.range_of(r)
    mine = dense_sum[lo:hi]
    sparse_full = np.zeros_like(mine)
    if got_ids.size:
        sparse_full[got_ids - lo] = got_rows
    dense_match = bool(np.array_equal(sparse_full, mine))

    # empty-partition edge: every id lands in rank 0's range, so all other
    # owners must see a zero-row result (and nobody deadlocks on the empty
    # frames)
    ids0 = np.array([0, 2, 0], np.int64)
    rows0 = np.full((3, 3), float(10 * (r + 1)), np.float32)
    e_ids, e_rows = group.sparse_reduce_scatter(ids0, rows0, plan.bounds)
    group.barrier()
    ctx.update_meta({"embed_probe": {
        "rank": r, "world": w,
        "echo_ids": echo_ids,
        "got_ids": got_ids.tolist(), "got_rows": got_rows.tolist(),
        "dense_match": dense_match,
        "empty_ids": e_ids.tolist(),
        "empty_shape": list(e_rows.shape),
    }})
    group.close()


def dense_setup(config, lr, device="cpu"):
    """The dense half of sharded wide-and-deep (weights from
    ``torch.Generator().manual_seed(0)``), its sharded grad fn and plain SGD
    (``optax.sgd``).  Map funs call it before they form their group: the
    first ``torch.optim`` optimizer of a process imports ``torch._dynamo``
    (about 2 s), and set-up between the generation barrier and the first
    round reads as a straggler to the peers."""
    import torch

    from tensorflowonspark_torch.models import wide_deep

    model = wide_deep.build_wide_deep_dense(config)
    wide_deep.init_dense_params(model, torch.Generator().manual_seed(0))
    model.to(device)
    opt = torch.optim.SGD(model.parameters(), lr=lr)
    return model, wide_deep.make_sharded_grad_fn(model), opt


def table_setup(plan, rank, group, table_seed):
    """One node's table shard (fused ``[embed_dim | wide weight]`` rows, the
    wide column zero as the monolithic model's) behind its
    ``ShardedTable``."""
    from tensorflowonspark_torch.embedding import EmbeddingShard, ShardedTable

    shard = EmbeddingShard.create(plan, rank, seed=table_seed,
                                  zero_cols=(plan.dim - 1,))
    return shard, ShardedTable(shard, group)


def sharded_step(model, opt, grad_fn, dense_reduce, table, batch, vocab, lr,
                 world):
    """One sharded step: look the batch's ids up through the sparse
    collectives, take the dense and row gradients, mean the dense ones
    across the group (``dense_reduce``) and apply them, and push the row
    gradients back to their owners.  Returns the loss tensor."""
    from tensorflowonspark_torch.models import wide_deep

    ids = wide_deep.flat_categorical_ids(batch["features"], vocab)
    rows = table.lookup(ids)
    (loss, _aux), (dg, rg) = grad_fn(model, rows, batch)
    dg = dense_reduce(dg)
    for name, p in model.named_parameters():
        p.grad = dg[name]
    opt.step()
    table.apply_gradients(ids, rg.cpu().numpy(), lr=lr, scale=1.0 / world)
    return loss


def train_wide_deep_sharded(args, ctx):
    """Sharded wide-and-deep sync training on deterministic synthetic-
    Criteo batches: dense half replicated (ring-averaged grads), fused
    embedding table range-sharded via the sparse collectives.  Publishes
    bit-comparison digests; with ``args.export_dir`` set, exports a
    sharded bundle (dense bundle + per-node shard ranges) for the serving
    tier (``tests/mapfuns.py:train_wide_deep_sharded``)."""
    from tensorflowonspark_torch.checkpoint import export_bundle
    from tensorflowonspark_torch.convert import torch_to_flax
    from tensorflowonspark_torch.embedding import ShardPlan
    from tensorflowonspark_torch.embedding.serve import (
        export_sharded_shard,
        sharded_config_block,
    )
    from tensorflowonspark_torch.gpu_info import default_device
    from tensorflowonspark_torch.models import wide_deep

    config = dict(args.get("model_config") or
                  {"model": "wide_deep_dense", "vocab_size": 97,
                   "embed_dim": 4, "hidden": (8,), "bf16": False})
    lr = float(args.get("lr", 0.125))  # power of two: exact at any world
    total = int(args.get("steps", 4))
    bsz = int(args.get("batch_size", 8))

    model, grad_fn, opt = dense_setup(config, lr, default_device(args.get("device")))
    group = ctx.collective_group(name="embed")
    group.form()
    block = (ctx.job_manifest().get("sync") or {}).get("embedding")
    plan = (ShardPlan.from_manifest(block) if block else
            ShardPlan.even("wide_deep", wide_deep.table_total_rows(config),
                           int(config["embed_dim"]) + 1, group.world))
    shard, table = table_setup(plan, group.rank, group,
                               int(args.get("table_seed", 11)))
    dense_reduce = group.grad_fn()  # ring mean — exact at world 2
    vocab = int(config["vocab_size"])

    losses = []
    for step in range(total):
        batch = criteo_batch(group.rank, step, bsz)
        loss = sharded_step(model, opt, grad_fn, dense_reduce, table, batch,
                            vocab, lr, group.world)
        losses.append(float(loss))
    group.barrier()
    if args.get("export_dir"):
        export_sharded_shard(args["export_dir"], plan, group.rank,
                             shard.rows, total)
        group.barrier()  # all shards committed before the chief's bundle
        if group.rank == 0:
            export_bundle(
                args["export_dir"], torch_to_flax(model.state_dict(), config=config),
                {**config, "sharded_embedding":
                 sharded_config_block(plan, total)})
        ctx.barrier("export")
    ctx.update_meta({"sharded_train": {
        "rank": group.rank, "world": group.world, "steps": total,
        "losses": losses,
        "dense_digest": dense_digest(model, config),
        "shard_digest": tree_digest({"rows": shard.rows}),
        "shard_range": [shard.lo, shard.hi],
        "stats": dict(table.stats),
        "manifest_embedding": block,
    }})
    group.close()


def sharded_embed_chaos(args, ctx):
    """Sharded-table sync training surviving a SIGKILL of a shard OWNER
    mid-step: nobody else holds the dead node's rows, so recovery is
    checkpoint-based — every completed step commits the shard range + the
    dense params, and after the generation reforms the members min-vote
    their newest complete checkpoint, ALL restore to it (survivors roll
    back), and the deterministic schedule replays
    (``tests/mapfuns.py:sharded_embed_chaos``)."""
    import glob
    import time

    import numpy as np
    import torch

    from tensorflowonspark_torch.collective import CollectiveAborted
    from tensorflowonspark_torch.embedding import ShardPlan
    from tensorflowonspark_torch.models import wide_deep

    config = dict(args.get("model_config") or
                  {"model": "wide_deep_dense", "vocab_size": 53,
                   "embed_dim": 3, "hidden": (8,), "bf16": False})
    lr = 0.125
    total = int(args["steps"])
    bsz = int(args.get("batch_size", 8))
    model_dir = args["model_dir"]
    eid = ctx.executor_id

    model, grad_fn, opt = dense_setup(config, lr)
    group = ctx.collective_group(name="embchaos", timeout=15.0)
    group.form(resume_step=0)
    plan = ShardPlan.even("chaos", wide_deep.table_total_rows(config),
                          int(config["embed_dim"]) + 1, group.world)
    shard, table = table_setup(plan, group.rank, group, 5)
    dense_reduce = group.grad_fn()
    vocab = int(config["vocab_size"])

    def dense_path(s):
        return os.path.join(model_dir, f"dense_e{eid}_s{s}.npz")

    def save_all(s):
        shard.save(model_dir, s)
        tmp = dense_path(s) + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **{k: v.numpy() for k, v in model.state_dict().items()})
        os.replace(tmp, dense_path(s))

    def restore_all(s):
        shard.restore(model_dir, s)
        with np.load(dense_path(s)) as z:
            model.load_state_dict({k: torch.from_numpy(z[k]) for k in z.files})
        # plain SGD keeps no state: nothing else to restore

    def latest_saved():
        best = -1
        for path in glob.glob(dense_path("*")):
            try:
                s = int(path.rsplit("_s", 1)[1][:-len(".npz")])
            except ValueError:
                continue
            shard_file = os.path.join(
                model_dir, f"embed_{plan.name}", f"step_{s}",
                f"shard_{shard.lo}_{shard.hi}.npz")
            if os.path.exists(shard_file):
                best = max(best, s)
        return best

    def rendezvous(reform):
        """(Re)align the group, min-vote the newest complete checkpoint,
        restore everyone to it.  Returns the agreed step."""
        deadline = time.monotonic() + 240.0
        while True:
            try:
                mine = latest_saved()
                if reform:
                    group.reform(resume_step=max(mine, 0))
                votes = group.all_gather(np.array([mine], np.int64))
                agreed = int(min(int(v[0]) for v in votes))
                if agreed < 0:
                    raise RuntimeError("no complete checkpoint on some member")
                restore_all(agreed)
                return agreed
            except (CollectiveAborted, RuntimeError, ConnectionError):
                reform = True
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.5)

    if ctx.is_restart:
        # the restarted victim: its in-memory table is fresh init — level
        # everyone from checkpoints (survivors roll back to the min vote)
        step = rendezvous(reform=False)
    else:
        save_all(0)
        step = 0
    reforms = 0
    while step < total:
        batch = criteo_batch(group.rank, step, bsz)
        try:
            # the victim's kill fires in the lookup's collectives
            sharded_step(model, opt, grad_fn, dense_reduce, table, batch,
                         vocab, lr, group.world)
        except CollectiveAborted:
            step = rendezvous(reform=True)
            reforms += 1
            continue
        step += 1
        save_all(step)
    while True:
        try:
            group.barrier(timeout=10.0)
            break
        except (CollectiveAborted, RuntimeError, ConnectionError):
            step = rendezvous(reform=True)
            reforms += 1
    ctx.update_meta({"embed_chaos": {
        "rank": group.rank, "steps": step, "reforms": reforms,
        "generation": group.generation, "incarnation": ctx.incarnation,
        "dense_digest": dense_digest(model, config),
        "shard_digest": tree_digest({"rows": shard.rows}),
    }})
    group.close()


def estimator_wide_deep_sharded(args, ctx):
    """Feed-driven sharded train_fn for the ``TorchEstimator`` path:
    synthetic-Criteo rows stream through the ordinary feed in lockstep, the
    fused table rides the sparse collectives, and the chief exports a
    sharded bundle to ``args.export_dir``
    (``tests/mapfuns.py:estimator_wide_deep_sharded``)."""
    import time

    import numpy as np

    from tensorflowonspark_torch.checkpoint import export_bundle
    from tensorflowonspark_torch.convert import torch_to_flax
    from tensorflowonspark_torch.embedding import ShardPlan
    from tensorflowonspark_torch.embedding.serve import (
        export_sharded_shard,
        sharded_config_block,
    )
    from tensorflowonspark_torch.gpu_info import default_device
    from tensorflowonspark_torch.models import wide_deep
    from tensorflowonspark_torch.parallel import dp as dplib

    config = dict(args.get("model_config") or {})
    if not config:
        raise ValueError("estimator_wide_deep_sharded needs model_config")
    lr = float(args.get("lr", 0.125))
    vocab = int(config["vocab_size"])

    model, grad_fn, opt = dense_setup(config, lr, default_device(args.get("device")))
    group = ctx.collective_group(name="embed")
    group.form()
    block = (ctx.job_manifest().get("sync") or {}).get("embedding")
    plan = (ShardPlan.from_manifest(block) if block else
            ShardPlan.even("wide_deep", wide_deep.table_total_rows(config),
                           int(config["embed_dim"]) + 1, group.world))
    shard, table = table_setup(plan, group.rank, group, 11)
    dense_reduce = group.grad_fn()

    feed = ctx.get_data_feed(train_mode=True)
    n_steps = 0
    loss = None
    step_secs = []
    for batch, _n in dplib.make_batch_iterator(
            feed, int(args.get("batch_size", 8)),
            wide_deep.batch_to_arrays, ctx=ctx, lockstep=True,
            max_steps=args.get("steps")):
        t0 = time.perf_counter()
        loss_v = sharded_step(model, opt, grad_fn, dense_reduce, table,
                              {k: np.asarray(v) for k, v in batch.items()},
                              vocab, lr, group.world)
        table.maybe_checkpoint(args.get("model_dir") or args.get("export_dir"),
                               n_steps)
        loss = float(loss_v)
        step_secs.append(time.perf_counter() - t0)
        n_steps += 1
    group.barrier()
    export_sharded_shard(args.get("export_dir"), plan, group.rank, shard.rows,
                         n_steps)
    group.barrier()
    if group.rank == 0:
        export_bundle(args.get("export_dir"),
                      torch_to_flax(model.state_dict(), config=config),
                      {**config, "sharded_embedding":
                       sharded_config_block(plan, n_steps)})
    ctx.barrier("export")
    ctx.update_meta({"sharded_train": {
        "rank": group.rank, "world": group.world, "steps": n_steps,
        "loss": loss, "stats": dict(table.stats),
        "step_secs": step_secs,
        "manifest_embedding": block,
    }})
    group.close()


def count_staged_rows(args, ctx):
    """A self-service DIRECT train_fn: read this node's share of the shards
    the estimator staged (``args.data_dir``) and write how many rows it
    read to ``args.log_dir``."""
    from tensorflowonspark_torch import dfutil

    files = dfutil.shard_files(args.data_dir)[ctx.executor_id::ctx.num_executors]
    schema = dfutil.read_schema(args.data_dir)
    n = sum(1 for f in files for _ in dfutil.read_shard(f, schema))
    with open(os.path.join(args.log_dir, f"staged_{ctx.executor_id}.txt"), "w") as f:
        f.write(str(n))


def train_wide_deep_sync(args, ctx):
    """Monolithic wide-and-deep in ``mode="sync"``: every node trains the
    whole model on its device from the same seed, and each step's gradients
    (the dense table's among them) mean-reduce across the nodes through
    ``ctx.collective_group().grad_fn()``.  Publishes the losses, a digest
    of the final parameters, and each step's exchange: its seconds (the
    backward finished first) and the bytes of the gradients it carried."""
    import time

    import numpy as np
    import torch

    from tensorflowonspark_torch.gpu_info import default_device
    from tensorflowonspark_torch.models import wide_deep
    from tensorflowonspark_torch.optim import Adagrad
    from tensorflowonspark_torch.parallel import dp as dplib

    config = dict(args["model_config"])
    device = default_device(args.get("device"))
    with torch.device(device):
        model = wide_deep.build_wide_deep(config)
    wide_deep.init_params(model, torch.Generator(device).manual_seed(0))
    optimizer = Adagrad(model.parameters(), float(args.get("lr", 0.01)))
    group = ctx.collective_group()
    group.form()
    state = dplib.TrainState.create(model, optimizer)
    reduce = group.grad_fn()
    secs, nbytes = [], []

    def timed_reduce(grads):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = reduce(grads)
        secs.append(time.perf_counter() - t0)
        nbytes.append(sum(g.numel() * g.element_size() for g in grads.values()))
        return out

    step = dplib.make_train_step(wide_deep.make_loss_fn(model), optimizer,
                                 cross_host_grad_fn=timed_reduce)
    feed = ctx.get_data_feed(train_mode=True)
    losses = []
    for batch, _n in dplib.make_batch_iterator(
            feed, int(args["batch_size"]), wide_deep.batch_to_arrays, ctx=ctx,
            lockstep=True):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    group.barrier()
    ctx.update_meta({"sync_wide_deep": {
        "rank": group.rank, "steps": int(state.step), "losses": losses,
        "digest": dense_digest(model, config),
        "reduce_secs": secs, "reduce_bytes": nbytes,
        "grad_device": str(model.embeddings.grad.device),
        "finite": bool(np.isfinite(losses).all()),
    }})
    group.close()


@contextlib.contextmanager
def world1_group(name: str = "solo"):
    """A formed one-member ``CollectiveGroup`` in this process (a
    coordinator, a data server as its peer wire, one registration), for
    tests of what the group does to trees without node processes."""
    from tensorflowonspark_torch.collective import CollectiveGroup
    from tensorflowonspark_torch.coordinator import CoordinatorClient, CoordinatorServer
    from tensorflowonspark_torch.dataserver import DataServer
    from tensorflowonspark_torch.feeding import FeedQueues

    authkey = b"world1-group"
    coord = CoordinatorServer(1, authkey=authkey)
    addr = coord.start("127.0.0.1")
    server = DataServer(FeedQueues(capacity=8), authkey, feed_timeout=30.0)
    port = server.start()
    client = CoordinatorClient(addr, authkey=authkey)
    group = None
    try:
        ident = client.register({"host": "127.0.0.1", "data_port": port,
                                 "pid": os.getpid()})
        eid = int(ident["executor_id"])
        client.set_identity(eid, int(ident.get("incarnation", 0)))
        group = CollectiveGroup(addr, authkey, eid, 1, "127.0.0.1", port,
                                name=name, timeout=30.0)
        group.form()
        yield group
    finally:
        if group is not None:
            group.close()
        client.close()
        server.stop()
        coord.stop()


def fsdp_bn_chief_save(args, ctx):
    """The small ResNet (float64) trained 2 BN steps over a 2-node
    ``fsdp=2`` mesh (``run(torch_distributed=True)``), saved through
    ``chief_save`` (the collective regime: every node writes its blocks),
    then restored onto a fresh state of the same mesh.  Writes
    ``fsdp_<rank>.json`` (the restore's step, whether every leaf came back
    bit for bit, and the next step's loss from both states) and, from rank
    0, ``full.pt``: ``tp.full_parameters`` of the trained model."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tensorflowonspark_torch.checkpoint import CheckpointManager, _leaves, chief_save
    from tensorflowonspark_torch.models import resnet as tres
    from tensorflowonspark_torch.parallel import dp as dplib
    from tensorflowonspark_torch.parallel import tp as tplib

    mesh = ctx.make_mesh("cpu", fsdp=2)

    def build():
        model = tres.ResNet(stage_sizes=(1, 1, 1), num_classes=10, width=8, stem="cifar",
                            compute_dtype=torch.float64, norm_dtype=torch.float64).double()
        model.init_weights(torch.Generator().manual_seed(0))
        dplib.replicate(model, mesh)
        tplib.shard_model(model, mesh, rules=())
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9, nesterov=True)
        return (dplib.BNTrainState.create(model, opt),
                dplib.make_bn_train_step(tres.make_loss_fn(model), opt, mesh=mesh))

    rank = dist.get_rank()
    rng = np.random.RandomState(rank)
    batch = {"image": torch.from_numpy(rng.rand(4, 32, 32, 3)),
             "label": torch.arange(4, dtype=torch.int32) + 4 * rank}
    state, step = build()
    for _ in range(2):
        state, _ = step(state, batch)
    manager = CheckpointManager(args["model_dir"])
    chief_save(ctx, manager, state.step, state.tree())
    full = tplib.full_parameters(state.model, mesh)
    if rank == 0:
        torch.save(full, os.path.join(args["model_dir"], "full.pt"))
    fresh, fresh_step = build()
    restored, at = manager.restore_latest(fresh.tree())
    fresh = fresh.restore(restored)
    pairs = list(zip(_leaves(state.tree()), _leaves(fresh.tree())))
    same = all(torch.equal(dplib._blocks(a), dplib._blocks(b)) for (_, a), (_, b) in pairs
               if isinstance(dplib._blocks(a), torch.Tensor))
    _, m_live = step(state, batch)
    _, m_restored = fresh_step(fresh, batch)
    with open(os.path.join(args["model_dir"], f"fsdp_{rank}.json"), "w") as f:
        json.dump({"step": at, "restored_step": fresh.step, "equal": same,
                   "leaves": len(pairs), "losses": [m_live["loss"].item(),
                                                    m_restored["loss"].item()]}, f)


def record_items(args, ctx):
    """Slow consumer that records every item it consumed — the autoscale
    coverage probe: the union of all nodes' files must cover the fed
    records exactly (duplicates allowed, loss not), whatever resizes
    happened mid-feed.  ``sleep_per_batch`` throttles consumption so a
    resize demonstrably lands while partitions are still queued/buffered.

    Each batch is appended and flushed as soon as it is consumed: the chaos
    test SIGKILLs this process mid-drain, and a write-at-exit log would
    silently lose every batch the victim consumed (the ledger only re-feeds
    what the victim never reported consumed)."""
    feed = ctx.get_data_feed(train_mode=True)
    out = os.path.join(args["out_dir"], f"node_{ctx.executor_id}.txt")
    with open(out, "a") as f:
        while not feed.should_stop():
            batch = feed.next_batch(args["batch_size"])
            if batch:
                f.write("".join(f"{int(x)}," for x in batch))
                f.flush()
                if args.get("sleep_per_batch"):
                    time.sleep(args["sleep_per_batch"])


def direct_record_counter(args, ctx):
    """DIRECT-mode consumer: ``ctx.get_data_feed`` returns the ingest feed
    (shard paths in, record payload bytes out).  Appends every record's
    utf-8 payload to a per-(executor, incarnation) coverage file — the
    at-least-once / exact-coverage probe for the direct-ingestion tests —
    and publishes the job manifest + per-incarnation record count via
    ``update_meta`` once the feed ends."""
    feed = ctx.get_data_feed(train_mode=True)
    cover = os.path.join(
        args["out_dir"], f"seen_{ctx.executor_id}_inc{ctx.incarnation}.txt")
    ctx.update_meta({"incarnation": ctx.incarnation})
    n = 0
    with open(cover, "a") as f:
        while not feed.should_stop():
            batch = feed.next_batch(args.get("batch_size", 16))
            if not batch:
                continue
            # zero-copy contract: records are memoryviews (plain shards)
            # or bytes (gzip); str() handles both without retaining views
            f.write("".join(str(rec, "utf-8") + "\n" for rec in batch))
            f.flush()
            n += len(batch)
            if args.get("sleep_per_batch"):
                # chaos pacing: keep the feed in flight long enough for a
                # mid-train fault to land deterministically
                time.sleep(args["sleep_per_batch"])
    ctx.update_meta({f"records_inc{ctx.incarnation}": n,
                     "manifest": ctx.job_manifest()})


def direct_fit_counter(args, ctx):
    """DIRECT-mode pipeline train_fn: drain the ledger-driven ingest feed
    and write this node's record count — the probe for the
    ``TorchEstimator.fit`` DIRECT-onto-the-ledger satellite (``args`` is the
    merged pipeline Namespace, so params arrive attribute-style)."""
    feed = ctx.get_data_feed(train_mode=True)
    n = 0
    while not feed.should_stop():
        n += len(feed.next_batch(args.get("batch_size", 16)))
    out = os.path.join(args.log_dir, f"fit_count_{ctx.executor_id}.txt")
    with open(out, "w") as f:
        f.write(str(n))


# -- ResNet fed from TFRecord shards through the DIRECT ingest tier -----------

IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)


def synthetic_image(seed: int, image_id: int, size: int):
    """A uint8 ``[size, size, 3]`` image that is a function of ``(seed, id)``
    alone: the shards hold these, and a replay regenerates any batch from
    its ids without reading the shards."""
    import numpy as np

    return np.random.default_rng([seed, image_id]).integers(
        0, 256, (size, size, 3), dtype=np.uint8)


def image_schema():
    """The shards' columns: the image's raw pixel bytes, its label and id."""
    from tensorflowonspark_torch import dfutil

    return dfutil.Schema([dfutil.ColumnSpec("id", "int64"),
                          dfutil.ColumnSpec("image", "bytes"),
                          dfutil.ColumnSpec("label", "int64")])


def write_image_shards(out_dir: str, n_images: int, per_shard: int, size: int,
                       seed: int, num_classes: int) -> list[str]:
    """``n_images`` synthetic Examples (``image`` H·W·3 uint8 bytes,
    ``label`` = id % num_classes, ``id``) in TFRecord shards of
    ``per_shard`` records, generated one shard at a time."""
    from tensorflowonspark_torch import dfutil
    from tensorflowonspark_torch.data import PartitionedDataset

    def shard(first):
        for i in range(first, min(first + per_shard, n_images)):
            yield {"id": i, "image": synthetic_image(seed, i, size).tobytes(),
                   "label": i % num_classes}

    data = PartitionedDataset([(lambda f=f: shard(f))
                               for f in range(0, n_images, per_shard)])
    dfutil.save_as_tfrecords(data, out_dir, image_schema())
    return dfutil.shard_files(out_dir)


def image_batches(feed, batch_size: int, size: int):
    """Whole batches of ``{"image": uint8 [n, H, W, 3], "label", "id"}`` from
    a columnar ``IngestFeed`` (a columnar batch never spans two decoded
    chunks, so short ones are joined); the last batch may be short."""
    images, labels, ids, n = [], [], [], 0
    while not feed.should_stop():
        cols = feed.next_batch(batch_size - n)
        if not cols:
            continue
        images.extend(cols["image"])
        labels.append(cols["label"])
        ids.append(cols["id"])
        n += len(cols["id"])
        if n == batch_size:
            yield _image_batch(images, labels, ids, size)
            images, labels, ids, n = [], [], [], 0
    if n:
        yield _image_batch(images, labels, ids, size)


def _image_batch(images, labels, ids, size):
    import numpy as np

    return {"image": np.frombuffer(b"".join(images), np.uint8).reshape(
                len(images), size, size, 3),
            "label": np.concatenate(labels), "id": np.concatenate(ids)}


def normalize_images(images):
    """uint8 NHWC pixels to float32 with the ImageNet mean and std, on the
    tensor's device (the host ships 1 byte a pixel, not 4)."""
    import torch

    mean = torch.tensor(IMAGE_MEAN, device=images.device)
    std = torch.tensor(IMAGE_STD, device=images.device)
    return (images.float() / 255.0 - mean) / std


def build_image_model(config: dict, seed: int, device):
    """The registry's model for ``config`` on ``device``, initialised from
    ``seed`` — the same weights in a node and in a replay."""
    import torch

    from tensorflowonspark_torch.models import registry

    with torch.device(device):
        model = registry.build(config)
    model.init_weights(torch.Generator(device=device).manual_seed(seed))
    return model


def device_idle_share(prof) -> dict:
    """The card's idle share over a ``profiling.trace``: one minus the union
    of the kernels' device intervals over the span from the first kernel's
    start to the last one's end (device clock)."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return {"idle_share": None, "busy_ms": 0.0, "window_ms": 0.0, "kernels": 0}
    busy, (cur_a, cur_b) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > cur_b:
            busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    window = spans[-1][1] - spans[0][0]
    return {"idle_share": 1.0 - busy / window, "busy_ms": busy / 1e3,
            "window_ms": window / 1e3, "kernels": len(spans)}


def ingest_resnet_trainer(args, ctx):
    """A BN-step ResNet trained from TFRecord shards through the DIRECT
    ingest feed: ``ctx.get_data_feed(schema=..., binary_features={"image"})``
    in columnar mode, batches moved by ``ingest.device_prefetch`` as uint8
    and normalised on the device, SGD Nesterov with L2 on the kernels.

    Writes ``ingest_result_<executor>.json`` to ``args["out_dir"]``: each
    step's ids and loss, the host time the loop waited for each batch,
    and per-step end marks (CUDA events on the card, the host clock on the
    CPU); with ``trace_dir``, the steps from ``warmup`` on run inside
    ``profiling.trace`` and the card's idle share over them is added; with
    ``save``, the trained weights go to ``trained_<executor>.pt``."""
    import contextlib
    import time

    import torch

    from tensorflowonspark_torch import profiling
    from tensorflowonspark_torch.gpu_info import default_device
    from tensorflowonspark_torch.ingest import device_prefetch
    from tensorflowonspark_torch.models import resnet
    from tensorflowonspark_torch.parallel import dp

    device = default_device(args.get("device"))
    cuda = device.type == "cuda"
    model = build_image_model(args["config"], args["seed"], device)
    optimizer = torch.optim.SGD(model.parameters(), lr=args["lr"], momentum=0.9,
                                nesterov=True)
    step = dp.make_bn_train_step(
        resnet.make_loss_fn(model, weight_decay=args["weight_decay"]), optimizer)
    state = dp.BNTrainState.create(model, optimizer)
    feed = ctx.get_data_feed(schema=image_schema(), binary_features={"image"},
                             readers=args.get("readers"))
    batches = device_prefetch(
        image_batches(feed, args["batch_size"], args["size"]),
        depth=args.get("depth", 2), device=device)
    losses, ids, waits, marks = [], [], [], []
    trace_dir, warmup = args.get("trace_dir"), args.get("warmup", 2)
    prof = None
    with contextlib.ExitStack() as stack:
        while True:
            if trace_dir and len(losses) == warmup:
                prof = stack.enter_context(profiling.trace(trace_dir))
            t = time.perf_counter()
            batch = next(batches, None)
            waits.append((time.perf_counter() - t) * 1e3)
            if batch is None:
                break
            state, m = step(state, {"image": normalize_images(batch["image"]),
                                    "label": batch["label"]})
            losses.append(m["loss"].detach())
            ids.append(batch["id"])
            if cuda:
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
            else:
                marks.append(time.perf_counter())
        if cuda:
            torch.cuda.synchronize()
    if cuda:
        marks = [marks[0].elapsed_time(e) for e in marks]
    else:
        marks = [(t - marks[0]) * 1e3 for t in marks]
    result = {"losses": [x.item() for x in losses],
              "ids": [x.cpu().tolist() for x in ids], "wait_ms": waits[:-1],
              "end_ms": marks, "device": str(device),
              "cuda_initialized": cuda and torch.cuda.is_initialized()}
    if prof is not None and cuda:
        result["trace"] = device_idle_share(prof)
    if args.get("save"):
        torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
                   os.path.join(args["out_dir"], f"trained_{ctx.executor_id}.pt"))
    with open(os.path.join(args["out_dir"],
                           f"ingest_result_{ctx.executor_id}.json"), "w") as f:
        json.dump(result, f)
