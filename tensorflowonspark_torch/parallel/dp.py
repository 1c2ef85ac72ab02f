"""Training step, eval step and batch feed — counterpart of
``tensorflowonspark_tpu/parallel/dp.py``.

Usage::

    model = build_transformer(config).to(device).init_weights(generator)
    optimizer = adamw(model.parameters(), 3e-4)
    state = TrainState.create(model, optimizer)
    step = make_train_step(make_loss_fn(model), optimizer)
    for batch, n in make_batch_iterator(feed, batch_size, to_arrays):
        state, metrics = step(state, batch)

``loss_fn(model, batch) -> (loss, aux_metrics)`` is the user contract (the
module takes the place of the JAX package's ``params``).  The step puts the
model in ``train()`` mode, updates its parameters in place and returns the
state with ``step + 1``.  A model with BatchNorm trains through the same
step (``make_bn_train_step``): its running statistics are module buffers
that the train-mode forward moves, and they travel in
``model.state_dict()``.

Over a device mesh (``parallel/mesh.py``): ``replicate`` puts the model
(or a tree) on the mesh's device with rank 0's values everywhere,
``make_batch_iterator(mesh=...)`` hands each rank its own rows
(``shard_batch``), and ``make_train_step(..., mesh=mesh)`` sums each
gradient over the ranks that computed parts of it (``dp``, ``fsdp`` unless
the parameter is sharded there, ``sp``) and divides by the batch ranks, so
the step equals the single-device step over the global batch::

    mesh = make_mesh(dp=-1, tp=2)
    model = shard_model(replicate(model, mesh), mesh)
    step = make_train_step(loss_fn, optimizer, mesh=mesh)
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


def adamw(params, lr: float) -> torch.optim.AdamW:
    """The optimizer that matches ``optax.adamw(lr)``: betas (0.9, 0.999),
    eps 1e-8 and weight decay 1e-4 on every parameter — optax's defaults.
    torch's own default weight decay (0.01) is 100 times optax's.

    Parameters on a CUDA device get PyTorch's fused AdamW (one kernel for
    all parameters); the CPU takes the for-each variant.  Both apply the
    same update."""
    params = list(params)
    fused = bool(params) and params[0].is_cuda
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4, fused=fused or None)


class TrainState(NamedTuple):
    """The model (its parameters), the optimizer that holds their state,
    and the count of steps taken."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int

    @classmethod
    def create(cls, model: torch.nn.Module,
               optimizer: torch.optim.Optimizer) -> "TrainState":
        return cls(model=model, optimizer=optimizer, step=0)

    def tree(self) -> dict:
        """The checkpoint tree of this state (the reference's
        ``jax.device_get(state)._asdict()``): ``{"model": state dict,
        "optimizer": state dict, "step": step}``.  A parameter that
        ``tp.shard_model`` split across processes, and the optimizer state
        of its shape, are ``checkpoint.Shard``s (the saver writes each
        rank's block, as orbax writes a global array's shards)."""
        tree = {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(), "step": int(self.step)}
        split = _split_parameters(self.model)
        if not split:
            return tree
        from tensorflowonspark_torch.checkpoint import Shard

        for name, p in self.model.named_parameters():
            if id(p) in split and name in tree["model"]:
                tree["model"][name] = Shard.of(tree["model"][name], split[id(p)])
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        state = tree["optimizer"]["state"]
        for i, entry in list(state.items()):
            s = split.get(id(params[i]))
            if s is not None:  # a new dict: the optimizer's own must not change
                state[i] = {k: Shard.of(v, s) if isinstance(v, torch.Tensor)
                            and v.shape == params[i].shape else v for k, v in entry.items()}
        return tree

    def restore(self, tree: dict) -> "TrainState":
        """Load a checkpoint ``tree`` into this state's model and optimizer
        (in place, onto their devices); returns the state at its step (the
        reference's ``TrainState(**tree)``).  Each leaf goes back to the
        placement the live state has: a ``Shard`` gives its block, and a
        whole tensor of a parameter split across processes (or of its
        optimizer state) is cut to this rank's block."""
        split = _split_parameters(self.model)
        if split:
            tree = self._place(tree, split)
        tree = _blocks(tree)
        self.model.load_state_dict(tree["model"])
        self.optimizer.load_state_dict(tree["optimizer"])
        return self._replace(step=int(tree["step"]))


    def _place(self, tree: dict, split: dict) -> dict:
        from tensorflowonspark_torch.checkpoint import Shard

        def block(v, p, sharding):
            if not isinstance(v, torch.Tensor) or v.shape == p.shape:
                return v
            mine = Shard.of(p.detach(), sharding)
            if tuple(v.shape) != mine.shape:
                return v  # load_state_dict names the mismatch
            return v[tuple(slice(o, o + n) for o, n in zip(mine.offset, p.shape))]

        model = dict(tree["model"])
        for name, p in self.model.named_parameters():
            if id(p) in split and name in model:
                model[name] = block(model[name], p, split[id(p)])
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        state = {}
        for i, entry in tree["optimizer"]["state"].items():
            s = split.get(id(params[int(i)]))
            state[i] = entry if s is None else {
                k: block(v, params[int(i)], s) for k, v in entry.items()}
        return {**tree, "model": model, "optimizer": {**tree["optimizer"], "state": state}}


def _split_parameters(model: torch.nn.Module) -> dict:
    """``{id(parameter): Sharding}`` of the parameters ``tp.shard_model``
    split across processes."""
    from tensorflowonspark_torch.parallel.mesh import axis_size
    from tensorflowonspark_torch.parallel.tp import param_name

    shardings = getattr(model, "tos_shardings", {})
    out = {}
    for name, p in model.named_parameters():
        s = shardings.get(param_name(name))
        if s is not None and any(axis_size(s.mesh, a) > 1
                                 for d in range(p.dim()) for a in s.axes_of(d)):
            out[id(p)] = s
    return out


def _blocks(tree):
    from tensorflowonspark_torch.checkpoint import Shard

    if isinstance(tree, Shard):
        return tree.local
    if isinstance(tree, dict):
        return {k: _blocks(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_blocks(v) for v in tree)
    return tree


def replicate(tree: Any, mesh) -> Any:
    """Place a model or a ``{name: tensor}`` tree on the mesh's device,
    every rank holding global rank 0's values (a broadcast over the world
    when the mesh spans processes).  A module's parameters and buffers move
    in place (``p.data``), so an optimizer built on them stays valid, and
    its ``BatchNorm``s take the batch axes' group (global statistics); a
    tree comes back as fresh tensors."""
    import torch.distributed as dist

    from tensorflowonspark_torch.parallel.mesh import device_of, is_multiprocess

    dev = device_of(mesh)
    spread = is_multiprocess(mesh)
    if isinstance(tree, torch.nn.Module):
        from tensorflowonspark_torch.parallel.tp import bind_batch_group

        with torch.no_grad():
            for t in list(tree.parameters()) + list(tree.buffers()):
                t.data = t.data.to(dev)
                if spread:
                    dist.broadcast(t.data, src=0)
        bind_batch_group(tree, mesh)
        return tree
    out = {k: torch.as_tensor(v).to(dev).clone() for k, v in tree.items()}
    if spread:
        for t in out.values():
            dist.broadcast(t, src=0)
    return out


def _mesh_grad_sync(model: torch.nn.Module, mesh, named: list) -> None:
    """Each gradient summed over the ranks that computed parts of it — the
    batch ranks (``dp``, and ``fsdp`` unless the parameter is sharded
    there, where its gather's backward has summed already) and the ``sp``
    ranks (each saw part of the sequence) — and divided by the number of
    batch ranks (each loss is its own rows' mean).  ``tp`` and ``ep``
    shards, and the parameters replicated over them, come out of the
    backward whole."""
    import torch.distributed as dist

    from tensorflowonspark_torch.parallel.mesh import axis_size, group
    from tensorflowonspark_torch.parallel.tp import param_name

    shardings = getattr(model, "tos_shardings", {})
    n = axis_size(mesh, "dp", "fsdp")
    for name, p in named:
        if p.grad is None:
            continue
        s = shardings.get(param_name(name))
        on_fsdp = s is not None and any("fsdp" in s.axes_of(d) for d in range(p.dim()))
        grp = group(mesh, *(("dp", "sp") if on_fsdp else ("dp", "fsdp", "sp")))
        if grp is not None:
            dist.all_reduce(p.grad, group=grp)
        if n > 1:
            p.grad /= n


def _mesh_metrics(metrics: dict, mesh) -> dict:
    """Metrics averaged over the batch ranks (each rank's are its rows')."""
    import torch.distributed as dist

    from tensorflowonspark_torch.parallel.mesh import axis_size, group

    grp = group(mesh, "dp", "fsdp")
    if grp is None:
        return metrics
    n = axis_size(mesh, "dp", "fsdp")
    out = {}
    for k, v in metrics.items():
        v = v.detach().float().clone()
        dist.all_reduce(v, group=grp)
        out[k] = v / n
    return out


def _to_device(batch: Any, device) -> Any:
    if isinstance(batch, dict):
        return {k: _to_device(v, device) for k, v in batch.items()}
    return torch.as_tensor(batch, device=device)


def _split(batch: Any, n: int) -> list:
    """``batch`` cut into ``n`` microbatches along axis 0."""
    if isinstance(batch, dict):
        parts = {k: _split(v, n) for k, v in batch.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    if batch.shape[0] % n:
        raise ValueError(f"batch of {batch.shape[0]} rows does not divide into "
                         f"accum_steps={n} microbatches")
    return list(batch.chunk(n, dim=0))


def make_train_step(
    loss_fn: Callable[[torch.nn.Module, Any], tuple[torch.Tensor, dict]],
    optimizer: torch.optim.Optimizer,
    accum_steps: int = 1,
    cross_host_grad_fn: Callable[[dict], dict] | None = None,
    mesh=None,
) -> Callable[[TrainState, Any], tuple[TrainState, dict]]:
    """Build the train step ``step(state, batch) -> (state, metrics)``.

    The batch's leaves (numpy or tensors) are moved to the model's device.
    Metrics stay device tensors: a step makes no host sync of its own.

    ``accum_steps > 1`` splits the batch into that many microbatches along
    axis 0 (it raises when they do not divide it), sums their gradients,
    averages gradients and metrics, and applies ONE update.  Caveat, as in
    the JAX package: each microbatch's loss is already normalised (by its
    own ``loss_mask`` count, for the LM loss), so with uneven mask density
    the weighting differs from the full-batch step; keep mask density
    uniform across microbatches or use ``accum_steps=1``.

    ``cross_host_grad_fn`` is applied to the ``{name: grad}`` dict between
    the backward and the update (e.g. an all-reduce across hosts); the
    gradients it returns are the ones applied.

    ``mesh``: the batch is this rank's rows (``shard_batch``) and the model
    may be cut by ``tp.shard_model``; after the backward each gradient is
    summed over the ranks that computed parts of it and divided by the
    batch ranks (``_mesh_grad_sync``), and the metrics are averaged over
    the batch ranks, so a dp × tp × fsdp (× sp, × ep) step equals the
    single-device step over the concatenated batch (for a plain mean loss;
    a ``loss_mask`` with uneven counts across ranks weights as
    ``accum_steps`` does).
    """
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def step(state: TrainState, batch: Any) -> tuple[TrainState, dict]:
        if state.optimizer is not optimizer:
            raise ValueError("the state holds another optimizer than this step's")
        model = state.model.train()
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        for _, p in named:
            p.grad = None
        batch = _to_device(batch, next(model.parameters()).device)
        micro = [batch] if accum_steps == 1 else _split(batch, accum_steps)
        msum: dict = {}
        for mb in micro:
            loss, aux = loss_fn(model, mb)
            loss.backward()
            for k, v in {"loss": loss, **aux}.items():
                v = v.detach()
                msum[k] = v if k not in msum else msum[k] + v
        if accum_steps > 1:
            for _, p in named:
                if p.grad is not None:
                    p.grad /= accum_steps
            msum = {k: v / accum_steps for k, v in msum.items()}
        if mesh is not None:
            _mesh_grad_sync(model, mesh, named)
            msum = _mesh_metrics(msum, mesh)
        if cross_host_grad_fn is not None:
            grads = cross_host_grad_fn({n: p.grad for n, p in named})
            for n, p in named:
                p.grad = grads[n]
        optimizer.step()
        return state._replace(step=state.step + 1), msum

    return step


# The JAX package's BN train state carries ``batch_stats`` beside the params;
# here they are buffers in ``model.state_dict()``, so ``TrainState.tree()``
# and ``restore()`` round-trip them and the BN state is the plain one.
BNTrainState = TrainState


def make_bn_train_step(
    loss_fn: Callable[[torch.nn.Module, Any], tuple[torch.Tensor, dict]],
    optimizer: torch.optim.Optimizer,
    mesh=None,
) -> Callable[[TrainState, Any], tuple[TrainState, dict]]:
    """Train step for models with BatchNorm — the counterpart of the JAX
    package's ``make_bn_train_step``, whose ``loss_fn`` returns the mutated
    ``batch_stats``.  Here ``loss_fn(model, batch) -> (loss, aux)`` runs the
    model in ``train()`` mode, where the forward normalises with the batch
    statistics and moves the running averages in place (flax's
    ``mutable=["batch_stats"]``), so this is ``make_train_step``.

    ``mesh``: as ``make_train_step``'s (each rank's rows, the gradients
    summed over ``dp``/``fsdp``), and the model placed on it (``replicate``,
    ``tp.shard_model``) normalises over the global batch, the JAX step over
    the global array."""
    return make_train_step(loss_fn, optimizer, mesh=mesh)


def make_eval_step(apply_fn: Callable[..., Any]) -> Callable[..., Any]:
    """Inference step: ``apply_fn`` under ``torch.inference_mode()``."""

    def eval_step(*args, **kwargs):
        with torch.inference_mode():
            return apply_fn(*args, **kwargs)

    return eval_step


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over the batch."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[:, None].long()).mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=-1) == labels).float().mean()


def make_batch_iterator(
    feed,
    batch_size: int,
    to_arrays: Callable[[list], Any],
    mesh=None,
    ctx=None,
    pad_to_batch: bool = True,
    prefetch: int = 2,
    max_steps: int | None = -1,
    lockstep: bool | None = None,
):
    """Drain a DataFeed into ready batches, yielding ``(batch, n)`` with
    ``n`` the real (unpadded) rows.

    A partial final batch is padded by repeating its last sample and, when
    ``ctx`` is given, a control-plane ``all_done`` consensus decides when
    *all* hosts stop — no host may leave the step loop early.  ``prefetch``
    > 0 drains, converts (``to_arrays``) and, where ``to_arrays`` puts the
    batch on the card, starts its copy for batch N+1 on a background thread
    while step N runs; ``0`` delivers synchronously.  ``max_steps`` >= 0
    caps the yielded batches (``None`` and ``-1`` mean uncapped); at the cap
    the feed is ``terminate()``d and the host votes dry.  ``lockstep`` forces
    the multi-host discipline (identical batch counts on every host, filler
    batches with ``n=0`` after a host runs dry), which needs ``ctx``.

    Weighting caveat: padded rows and filler rows enter the loss mean like
    real rows; use ``n`` to weight or skip such updates.

    ``mesh``: each batch goes through ``mesh.shard_batch`` (this rank's
    rows on the mesh's device; ranks that differ only off the batch axes
    take the first one's) on the consumer's thread, since collectives must
    keep one order on every rank; ``lockstep`` defaults to whether the mesh
    spans processes.
    """
    if lockstep is None and mesh is not None:
        from tensorflowonspark_torch.parallel.mesh import is_multiprocess

        lockstep = is_multiprocess(mesh)
    inner = _batch_iterator(feed, batch_size, to_arrays, ctx, pad_to_batch,
                            -1 if max_steps is None else int(max_steps),
                            lockstep)
    if prefetch > 0:
        inner = _prefetch_iterator(inner, prefetch)
    if mesh is None:
        yield from inner
        return
    from tensorflowonspark_torch.parallel.mesh import shard_batch

    try:
        for batch, n in inner:
            yield shard_batch(mesh, batch), n
    finally:
        inner.close()


def _prefetch_iterator(inner, depth: int):
    """Run ``inner`` on a background thread through a bounded queue.

    An abandoned consumer (early ``break`` → ``GeneratorExit``) must not
    leave the producer blocked on a full queue holding the feed: ``close()``
    sets a stop flag and drains, and the producer re-checks it around every
    put.  Producer exceptions re-raise at the consumer's next pull — the same
    point they would have surfaced unprefetched.
    """
    import queue as _queue
    import threading

    q: _queue.Queue = _queue.Queue(maxsize=depth)
    stop = threading.Event()
    END = object()
    failure: list[BaseException] = []

    def _produce() -> None:
        try:
            for item in inner:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except _queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised consumer-side
            failure.append(e)
        finally:
            inner.close()
            while not stop.is_set():
                try:
                    q.put(END, timeout=0.1)
                    break
                except _queue.Full:
                    continue

    thread = threading.Thread(target=_produce, name="batch-prefetch", daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is END:
                break
            yield item
        if failure:
            raise failure[0]
        thread.join()
    finally:
        stop.set()
        thread.join(timeout=30.0)


def _batch_iterator(
    feed,
    batch_size: int,
    to_arrays: Callable[[list], Any],
    ctx=None,
    pad_to_batch: bool = True,
    max_steps: int = -1,
    lockstep: bool | None = None,
):
    if getattr(feed, "input_mapping", None):
        raise ValueError(
            "make_batch_iterator needs row-shaped batches; construct the "
            "DataFeed without input_mapping and map columns in to_arrays"
        )
    # Multi-host lockstep: every host runs one global step per consensus
    # round, so the number of yielded batches must be identical on every
    # host.  A host whose feed runs dry before the others keeps yielding
    # FILLER batches (its last real sample repeated, reported as n=0) until
    # the all_done consensus turns true — if it just skipped rounds, the
    # still-active hosts would enter the next collective without it and the
    # job would hang.
    multiproc = bool(lockstep)
    if multiproc and ctx is None:
        raise ValueError(
            "lockstep (cross-host sync) streaming requires ctx: the all_done "
            "consensus is what keeps per-host global-step counts in lockstep"
        )
    if multiproc and not pad_to_batch:
        raise ValueError(
            "lockstep streaming requires pad_to_batch=True: every "
            "host must contribute the same local batch shape or the global "
            "step (batch assembly / gradient collective) diverges"
        )
    last_item = None   # filler source for multi-process end-of-data rounds
    exhausted = False  # feed hit end-of-feed: NEVER call next_batch again
    dry = False        # exhausted and nothing left to yield
    yielded = 0
    pending = None     # pipelined consensus vote from the previous round
    try:
        while True:
            if max_steps >= 0 and yielded >= max_steps and not dry:
                # steps cap: behave exactly like end-of-data from here on —
                # terminate the feed (upstream streaming stops fast) and vote
                # dry in the consensus.
                terminate = getattr(feed, "terminate", None)
                if terminate is not None and not exhausted:
                    terminate()
                exhausted = dry = True
            items: list = []
            if not dry:
                if not exhausted:
                    items = feed.next_batch(batch_size)
                    # EndOfFeed can arrive mid-batch: a non-empty partial batch
                    # with should_stop() set must still be trained on, but one
                    # more next_batch() call would block forever.
                    exhausted = feed.should_stop()
                dry = exhausted and not items
            if ctx is not None:
                # One consensus round per step: active hosts vote False once
                # per batch; dry hosts keep voting True (without touching the
                # feed) until everyone is dry, so no host exits the loop
                # early.  An active host's vote is pipelined: it sends its
                # vote, runs the step while the rendezvous resolves, and
                # reads the result at the top of the next round.  A dry host
                # resolves synchronously, so exit timing and yield counts are
                # those of the fully synchronous protocol.
                if pending is not None:
                    prev, pending = pending(), None
                    if prev:
                        # impossible by construction: this host voted
                        # "active" in that generation and the reduce is
                        # kind="all"
                        raise RuntimeError(
                            "end-of-data consensus turned true in a round "
                            "this host voted active (protocol bug)")
                if dry:
                    if ctx.all_done(dry):
                        return
                else:
                    pending = ctx.all_done_begin(False)
            elif dry:
                return
            if not items and not multiproc:
                continue
            n = len(items)
            if not items:
                # lockstep: this host is dry (or drew an empty batch) but
                # other hosts still have data — join their global step with
                # a filler.
                if last_item is None:
                    raise RuntimeError(
                        "lockstep streaming: this host reached end-of-feed "
                        "before receiving any data; every data node needs at "
                        "least one sample to participate in the global step"
                    )
                items = [last_item] * batch_size
            else:
                last_item = items[-1]
            if pad_to_batch and len(items) < batch_size:
                items = list(items) + [items[-1]] * (batch_size - len(items))
            yield to_arrays(items), n
            yielded += 1
    finally:
        if pending is not None and ctx is not None:
            # The caller abandoned the iterator (break / exception in its
            # train step) with a vote in flight; the unread reply would
            # desync any future consensus on this connection — drop it.
            ctx._reset_consensus_client()
