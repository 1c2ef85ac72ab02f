"""Training checkpoints and inference bundles — the port of
``tensorflowonspark_tpu/checkpoint.py``.

**Training checkpoints** (the reference's orbax half, ``:30-262``).  A
checkpoint is a directory holding ``tree.pt``: a nested tree of dicts,
lists and tuples whose leaves are tensors, numpy arrays and scalars — for a
``parallel/dp.py`` ``TrainState`` ``{"model": model.state_dict(),
"optimizer": optimizer.state_dict(), "step": step}`` (``TrainState.tree``).
It is written with ``torch.save`` into a temporary directory whose name
does not match ``step_<digits>`` and committed by ``os.replace``, so
``latest_step_dir`` and ``CheckpointManager.restore_latest`` only ever see
complete checkpoints; it is read with ``torch.load(..., map_location="cpu",
weights_only=True)`` (numpy leaves ride as tensors and come back as numpy).
These are the port's own format: the port does not read the JAX package's
orbax checkpoint directories, nor they its.  ``hdfs://`` and ``hopsfs://``
paths resolve through ``utils.paths.resolve_uri``.

``CheckpointManager`` keeps the newest K ``step_N`` directories of one
model_dir and saves asynchronously by default: ``save`` returns once the
tree is snapshotted to host memory (detached CPU copies, so the train loop
may go on updating its tensors), a background thread commits it (one save
in flight per process), and ``wait_for_saves`` blocks until it has,
raising the save's error if it failed.  ``restore_for_restart`` is the elastic-restart resume a
restartable map_fun calls first (``ctx.is_restart``); ``chief_save`` is the
multi-node save.

**State sharded across processes** (the reference's collective orbax
save, ``:227-263``, and its host-side restore, ``:86-120``).  A tree whose
leaves include ``Shard``s (this rank's block of a tensor, its whole shape
and offset: ``parallel.dp.TrainState.tree()`` of a ``shard_model``-ed
model) is saved by every rank of the ``torch.distributed`` world together,
synchronously: each rank writes its blocks as ``shards_<rank>.pt`` into one
temporary directory, rank 0 writes ``tree.pt`` (the tree with a
``{"__shard__": shape}`` marker in each block's place) and commits by
rename, and nobody returns before the commit.  ``restore_checkpoint``
reassembles each marked tensor from the blocks: with a target it hands
back each target ``Shard`` with this rank's block read from disk, without
one the whole tensor (a single process reads a checkpoint the ranks wrote
together).

**Inference bundles.**  A bundle is a directory holding ``params.npz`` (the
flat param tree, keys ``a/b/c``, committed by atomic rename) and
``bundle.json`` (the model config).  The format is shared with the JAX
package: each side reads the other's bundles.  16-bit and 8-bit float
leaves that numpy cannot name (bfloat16, float8) ride as raw bytes with
their dtype names under the reserved ``_param_dtypes`` key of
``bundle.json``; the port reads them as unsigned integers viewed as the
torch dtype, so it needs no ``ml_dtypes``.

**Embedding-shard checkpoints** (the reference's ``:506-614``, a copy):
each node of a sharded embedding table commits its own row range as
``<model_dir>/embed_<table>/step_<N>/shard_<lo>_<hi>.npz``, and
``restore_embedding_shard`` reassembles any ``[lo, hi)`` from whatever
shard files cover it (the layout is shared with the JAX package).

**Programs** (the reference's ``export_stablehlo``, ``:384-431``):
``export_program`` writes a ``torch.export`` program that scores without
the model registry: with ``torch`` alone, or, where the model attends,
with the module that registers the attention operator.

The orbax bundle layout (a ``params/`` checkpoint directory, written by the
JAX package for cross-process-sharded params) is not read by the port yet.
"""

from __future__ import annotations

import copy
import dataclasses
import glob
import itertools
import json
import logging
import os
import shutil
import threading
from typing import Any, Callable

import numpy as np
import torch

from tensorflowonspark_torch.utils.locks import tos_named_lock
from tensorflowonspark_torch.utils.paths import resolve_uri

logger = logging.getLogger(__name__)

# ml_dtypes name -> (numpy storage type, torch dtype)
_EXTENDED_DTYPES = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}
_TORCH_TO_EXTENDED = {t: (name, st) for name, (st, t) in _EXTENDED_DTYPES.items()}


# -- training checkpoints -----------------------------------------------------

_TREE_FILE = "tree.pt"
_NDARRAY_KEY = "__ndarray__"  # a numpy leaf, stored as {_NDARRAY_KEY: tensor}
_TMP_IDS = itertools.count()


def _snapshot(tree: Any) -> Any:
    """A copy of ``tree`` that shares no storage with it and that
    ``torch.load(weights_only=True)`` reads back: tensors as detached CPU
    copies, numpy arrays as tensors under ``_NDARRAY_KEY``, NamedTuples as
    tuples."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, (np.ndarray, np.generic)):
        return {_NDARRAY_KEY: torch.from_numpy(np.array(tree, copy=True))}
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):  # a NamedTuple is saved as a tuple
        items = [_snapshot(v) for v in tree]
        return tuple(items) if isinstance(tree, tuple) else items
    return copy.deepcopy(tree)


def _unsnapshot(tree: Any) -> Any:
    if isinstance(tree, dict):
        if set(tree) == {_NDARRAY_KEY}:
            return tree[_NDARRAY_KEY].numpy()
        return {k: _unsnapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_unsnapshot(v) for v in tree]
        return tuple(items) if isinstance(tree, tuple) else items
    return tree


def _write_tree(local: str, snapshot: Any) -> None:
    """Write ``snapshot`` into a temporary directory beside ``local`` and
    commit it there by rename; an existing checkpoint at ``local`` is
    replaced."""
    parent, name = os.path.split(local.rstrip(os.sep))
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f".{name}.tmp-{os.getpid()}-{next(_TMP_IDS)}")
    os.makedirs(tmp)
    try:
        torch.save(snapshot, os.path.join(tmp, _TREE_FILE))
        if os.path.exists(local):  # force: move the old one aside first
            old = f"{tmp}.old"
            os.replace(local, old)
            shutil.rmtree(old, ignore_errors=True)
        os.replace(tmp, local)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


class _AsyncSave(threading.Thread):
    """One snapshot's write and commit, off the caller's thread.  Not a
    daemon: the interpreter waits for it at exit."""

    def __init__(self, local: str, snapshot: Any):
        super().__init__(name="tos-ckpt-save")
        self.local, self.snapshot = local, snapshot
        self.error: BaseException | None = None

    def run(self) -> None:
        try:
            _write_tree(self.local, self.snapshot)
        except BaseException as e:  # noqa: BLE001 - raised by wait_for_saves()
            logger.error("async checkpoint save to %s failed: %r", self.local, e)
            self.error = e


_IN_FLIGHT: _AsyncSave | None = None  # at most one async save at a time
_IN_FLIGHT_LOCK = tos_named_lock("checkpoint._in_flight_lock")


def wait_for_saves() -> None:
    """Block until the in-flight async checkpoint save has committed;
    raises ``RuntimeError`` if it failed."""
    global _IN_FLIGHT
    with _IN_FLIGHT_LOCK:
        save, _IN_FLIGHT = _IN_FLIGHT, None
    if save is not None:
        save.join()
        if save.error is not None:
            raise RuntimeError(f"the async checkpoint save to {save.local} "
                               f"failed: {save.error!r}") from save.error


@dataclasses.dataclass
class Shard:
    """This rank's block of a tensor sharded across processes: ``local`` is
    the block, ``shape`` the whole tensor's and ``offset`` the block's first
    index along each dim."""

    local: torch.Tensor
    shape: tuple
    offset: tuple

    @classmethod
    def of(cls, local: torch.Tensor, sharding) -> "Shard":
        """The block ``local`` of ``sharding`` (a ``parallel.mesh.Sharding``)
        on this rank."""
        from tensorflowonspark_torch.parallel.mesh import axis_index, axis_size

        shape, offset = [], []
        for d, n_local in enumerate(local.shape):
            axes = sharding.axes_of(d)
            n = axis_size(sharding.mesh, *axes) if axes else 1
            shape.append(n_local * n)
            offset.append(axis_index(sharding.mesh, *axes) * n_local if n > 1 else 0)
        return cls(local, tuple(shape), tuple(offset))


_SHARD_KEY = "__shard__"  # a Shard's place in tree.pt: {_SHARD_KEY: whole shape}


def _map_leaves(tree: Any, fn: Callable, path: str = "") -> Any:
    """``tree`` with each leaf replaced by ``fn(leaf, path)`` (paths as
    ``_leaves`` writes them)."""
    if isinstance(tree, dict) and set(tree) != {_SHARD_KEY}:
        return {k: _map_leaves(v, fn, f"{path}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_map_leaves(v, fn, f"{path}/{i}") for i, v in enumerate(tree)]
        return tuple(items) if isinstance(tree, tuple) else items
    return fn(tree, path or "/")


def has_shards(tree: Any) -> bool:
    """Whether ``tree`` holds ``Shard`` leaves (its save is then a
    collective of every rank)."""
    found = []
    _map_leaves(tree, lambda leaf, _: found.append(isinstance(leaf, Shard)))
    return any(found)


def _rank_world() -> tuple[int, int]:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier() -> None:
    if _rank_world()[1] > 1:
        torch.distributed.barrier()


def _collective_save(local: str, tree: Any) -> None:
    """Every rank's blocks into one temporary directory, rank 0's
    ``tree.pt`` and the commit by rename; returns on every rank once
    committed."""
    rank, world = _rank_world()
    parent, name = os.path.split(local.rstrip(os.sep))
    tmp = os.path.join(parent, f".{name}.tmp-collective")
    if rank == 0:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    _barrier()
    blocks: dict = {}

    def strip(leaf, path):
        if not isinstance(leaf, Shard):
            return leaf
        blocks[path] = {"local": leaf.local.detach().to("cpu", copy=True),
                        "offset": list(leaf.offset)}
        return {_SHARD_KEY: list(leaf.shape)}

    skeleton = _map_leaves(tree, strip)
    try:
        torch.save(blocks, os.path.join(tmp, f"shards_{rank}.pt"))
        _barrier()  # every block written
        if rank == 0:
            torch.save(_snapshot(skeleton), os.path.join(tmp, _TREE_FILE))
            if os.path.exists(local):
                old = f"{tmp}.old"
                os.replace(local, old)
                shutil.rmtree(old, ignore_errors=True)
            os.replace(tmp, local)
    finally:
        _barrier()  # committed (or failed) before anyone returns
    if not os.path.isdir(local) and world > 1:
        raise RuntimeError(f"the collective checkpoint save to {local} did not commit")


def _assemble(local: str, raw: Any) -> Any:
    """``raw`` with each shard marker replaced by ``(whole tensor)`` built
    from every rank's blocks."""
    blocks: dict = {}
    for f in sorted(glob.glob(os.path.join(local, "shards_*.pt"))):
        for path, b in torch.load(f, map_location="cpu", weights_only=True).items():
            blocks.setdefault(path, []).append(b)

    def whole(leaf, path):
        if not (isinstance(leaf, dict) and set(leaf) == {_SHARD_KEY}):
            return leaf
        shape = tuple(int(n) for n in leaf[_SHARD_KEY])
        parts = blocks.get(path, [])
        if not parts:
            raise ValueError(f"checkpoint at {local} holds no blocks of {path}")
        out = torch.empty(shape, dtype=parts[0]["local"].dtype)
        covered = torch.zeros(shape, dtype=torch.bool)
        for b in parts:
            idx = tuple(slice(o, o + n) for o, n in zip(b["offset"], b["local"].shape))
            out[idx] = b["local"]
            covered[idx] = True
        if not bool(covered.all()):
            raise ValueError(f"checkpoint at {local}: the blocks of {path} do not cover "
                             f"its shape {shape}")
        return out

    return _map_leaves(raw, whole)


def _cut(raw: Any, target: Any) -> Any:
    """Each whole tensor of ``raw`` where ``target`` holds a ``Shard``
    replaced by a ``Shard`` of the target's block."""
    if isinstance(target, Shard):
        if tuple(raw.shape) != tuple(target.shape):
            return raw  # the shape check below names it
        idx = tuple(slice(o, o + n) for o, n in zip(target.offset, target.local.shape))
        return Shard(raw[idx].clone(), target.shape, target.offset)
    if isinstance(target, dict) and isinstance(raw, dict):
        return {k: _cut(v, target[k]) if k in target else v for k, v in raw.items()}
    if (isinstance(target, (list, tuple)) and isinstance(raw, (list, tuple))
            and len(target) == len(raw)):
        items = [_cut(v, t) for v, t in zip(raw, target)]
        return tuple(items) if isinstance(raw, tuple) else items
    return raw


def save_checkpoint(path: str, tree: Any, force: bool = True,
                    async_save: bool = False) -> str:
    """Save a tree checkpoint to a (possibly hdfs://-mapped) path.

    The tree is snapshotted to host memory before this returns.  With
    ``async_save=True`` a background thread commits it, once the save
    before it has committed (one save in flight: the keep-newest window
    counts on that); call ``wait_for_saves()`` (or
    ``CheckpointManager.wait()``) before reading it back.
    ``force=False`` refuses to replace an existing checkpoint at ``path``.

    A tree holding ``Shard``s is saved collectively and synchronously:
    every rank of the world calls this with its own blocks (module
    docstring).
    """
    global _IN_FLIGHT
    local = os.path.abspath(resolve_uri(path))
    if not force and os.path.exists(local):
        raise FileExistsError(f"checkpoint {path} exists (force=False)")
    if has_shards(tree):
        wait_for_saves()
        _collective_save(local, tree)
        return local
    snapshot = _snapshot(tree)
    if async_save:
        wait_for_saves()  # one save in flight, as orbax's async saver
        save = _AsyncSave(local, snapshot)
        with _IN_FLIGHT_LOCK:
            _IN_FLIGHT = save
        save.start()
    else:
        _write_tree(local, snapshot)
    return local


def _leaves(tree: Any, path: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` pairs in a fixed order (dict keys sorted, as the
    reference's pytree flattening sorts them)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree, key=lambda k: (type(k).__name__, k)):
            out.extend(_leaves(tree[k], f"{path}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{path}/{i}")]
    return [(path or "/", tree)]


def _prune_lazy(tree: Any, target: Any) -> Any:
    """``tree`` with the subtrees cut where ``target`` holds an empty dict
    (a torch optimizer's state before its first step): those take whatever
    the checkpoint holds."""
    if isinstance(target, dict) and isinstance(tree, dict):
        if not target:
            return {}
        return {k: _prune_lazy(v, target[k]) if k in target else v
                for k, v in tree.items()}
    if (isinstance(target, (list, tuple)) and isinstance(tree, (list, tuple))
            and len(target) == len(tree)):
        return [_prune_lazy(v, t) for v, t in zip(tree, target)]
    return tree


def restore_checkpoint(path: str, target: Any | None = None) -> Any:
    """Restore a tree; leaves come back on the CPU (tensors, numpy arrays,
    scalars) in the containers they were saved in.

    ``target`` (a tree of the same structure, e.g. a fresh ``TrainState``'s
    ``tree()``) is checked against the checkpoint as the reference checks
    it: a different leaf count or a leaf of another shape means the
    checkpoint does not belong to this model, and raises ``ValueError``
    naming ``path``.  An empty dict in the target (a torch optimizer's
    lazily built state) matches whatever the checkpoint holds there.

    A checkpoint saved collectively (``Shard`` leaves) comes back whole
    without a target; where the target holds a ``Shard``, the result holds
    a ``Shard`` of the same block read from disk.
    """
    local = os.path.abspath(resolve_uri(path))
    raw = _unsnapshot(torch.load(os.path.join(local, _TREE_FILE),
                                 map_location="cpu", weights_only=True))
    if glob.glob(os.path.join(local, "shards_*.pt")):
        raw = _assemble(local, raw)
        if target is not None:
            raw = _cut(raw, target)
    if target is None:
        return raw
    got, want = _leaves(_prune_lazy(raw, target)), _leaves(target)
    if len(got) != len(want):
        raise ValueError(
            f"checkpoint at {path} has {len(got)} leaves but the restore target "
            f"expects {len(want)} — wrong model/optimizer?")
    for (gpath, g), (_, w) in zip(got, want):
        gs, ws = tuple(getattr(g, "shape", ())), tuple(getattr(w, "shape", ()))
        if gs != ws:
            raise ValueError(f"checkpoint leaf {gpath} shape {gs} != target shape "
                             f"{ws} at {path}")
    return raw


def _step_dirs(model_dir: str) -> list[tuple[int, str]]:
    """Sorted (step, uri_path) pairs for ``step_N`` dirs under model_dir."""
    local = resolve_uri(model_dir)
    if not os.path.isdir(local):
        return []
    steps = sorted(
        int(n[5:]) for n in os.listdir(local) if n.startswith("step_") and n[5:].isdigit()
    )
    return [(s, os.path.join(model_dir, f"step_{s}")) for s in steps]


def latest_step_dir(model_dir: str) -> str | None:
    """Find the latest ``step_N`` checkpoint under ``model_dir``."""
    dirs = _step_dirs(model_dir)
    return dirs[-1][1] if dirs else None


class CheckpointManager:
    """Step-indexed checkpoints under one model_dir (keeps the newest K).

    Saves are **async by default**: the snapshot to host memory happens
    before ``save`` returns (so the train loop may update its tensors in
    place), and the write overlaps later steps.  Each save commits by
    rename, so a crash mid-save never leaves a readable partial ``step_N``
    directory and ``restore_latest`` only ever sees complete checkpoints.
    """

    def __init__(self, model_dir: str, max_to_keep: int = 3, async_save: bool = True):
        self.model_dir = model_dir
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        os.makedirs(resolve_uri(model_dir), exist_ok=True)

    def save(self, step: int, tree: Any) -> str:
        path = os.path.join(self.model_dir, f"step_{int(step)}")
        save_checkpoint(path, tree, async_save=self.async_save)
        self._gc(pending_step=int(step))
        return path

    def wait(self) -> None:
        """Block until in-flight async saves are committed."""
        wait_for_saves()

    def restore_latest(self, target: Any | None = None) -> tuple[Any, int] | None:
        wait_for_saves()  # an in-flight save may be the latest step
        dirs = _step_dirs(self.model_dir)
        if not dirs:
            return None
        step, path = dirs[-1]
        return restore_checkpoint(path, target), step

    def _gc(self, pending_step: int | None = None) -> None:
        # Single-writer deletion: when every rank of a torch.distributed
        # group saves, concurrent rmtrees of the same step dirs on shared
        # storage could show a half-deleted dir as the newest checkpoint to
        # a concurrent reader.  All ranks compute the same keep-K set, so
        # only rank 0 deletes.
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1 \
                and dist.get_rank() != 0:
            return
        # Only committed dirs appear in _step_dirs; an async save still in
        # flight is invisible, so count it explicitly (``pending_step``) or
        # the keep-K window would run one checkpoint too large.
        dirs = _step_dirs(self.model_dir)
        pending = 1 if (pending_step is not None
                        and pending_step not in [s for s, _ in dirs]) else 0
        excess = len(dirs) + pending - self.max_to_keep
        for _, path in dirs[: max(0, excess)]:
            shutil.rmtree(resolve_uri(path), ignore_errors=True)


def restore_for_restart(ctx, manager: CheckpointManager,
                        target: Any | None = None) -> tuple[Any, int] | None:
    """Elastic-recovery resume: load the newest committed checkpoint before
    (re-)entering the feed loop.

    Call this at the top of a restartable map_fun.  On a first launch with an
    empty model_dir it returns None (train from init); on a supervised
    restart (``ctx.is_restart``) — or a rerun over a warm model_dir — it
    returns ``(tree, step)`` from the latest ``step_N`` so the replacement
    continues instead of repeating finished work.  The commit by rename
    guarantees the result is never a torn mid-save state.
    """
    out = manager.restore_latest(target)
    if out is None:
        if ctx.is_restart:
            logger.warning(
                "node %d restarted (incarnation %d) but %s holds no committed "
                "checkpoint; restarting the work from scratch",
                ctx.executor_id, ctx.incarnation, manager.model_dir)
        return None
    _, step = out
    logger.info("node %d (incarnation %d) resuming from step %d of %s",
                ctx.executor_id, ctx.incarnation, step, manager.model_dir)
    return out


def chief_save(ctx, manager: CheckpointManager, step: int, tree: Any,
               timeout: float = 600.0) -> None:
    """Multi-node save coordination.

    Two regimes, selected by the tree:

    - **host-local state** (each process holds full values: pure data
      parallelism, or independent single-process models): executor 0 saves
      and waits for the commit.  N nodes writing the same bytes would race
      on the commit rename.
    - **state sharded across processes** (``Shard`` leaves: the
      ``TrainState.tree()`` of a ``shard_model``-ed model over a
      ``torch.distributed`` world of the data nodes, e.g. fsdp): the save
      is a collective, so EVERY data node calls it; each writes its own
      blocks and rank 0 commits atomically.

    Either way every data node then meets at a barrier, which releases only
    after the save has committed, so a node that crashes right after this
    call can still restart from the step just written.
    """
    if has_shards(tree) or ctx.executor_id == 0:
        manager.save(step, tree)
        manager.wait()
    # Data-node scope: the evaluator role never trains and never calls this,
    # so an all-nodes barrier would deadlock any cluster running one.
    ctx.barrier("checkpoint", timeout=timeout, group="data")


# -- inference bundles (SavedModel analogue) ---------------------------------

def _flatten_tree(tree: Any, prefix: str = "") -> dict:
    """Nested dict-of-arrays -> flat {'a/b/c': array} (bundle npz keys)."""
    flat = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else str(k)
            flat.update(_flatten_tree(v, key))
    else:
        flat[prefix] = tree
    return flat


def _unflatten_tree(flat: dict) -> Any:
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def _to_storage(leaf) -> tuple[np.ndarray, str | None]:
    """A leaf as the array npz stores, plus its extended dtype name (or None)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype in _TORCH_TO_EXTENDED:
            name, storage = _TORCH_TO_EXTENDED[t.dtype]
            return t.contiguous().view(torch.uint16 if storage is np.uint16
                                       else torch.uint8).numpy(), name
        return t.numpy(), None
    return np.asarray(leaf), None


def export_bundle(export_dir: str, params: Any, model_config: dict) -> str:
    """Export params + config for serving.  Leaves may be numpy arrays or
    tensors; ``model_config`` must rebuild the apply fn through the model
    registry (``{"model": "transformer", ...}``)."""
    local = resolve_uri(export_dir)
    os.makedirs(local, exist_ok=True)
    flat, extended = {}, {}
    for k, leaf in _flatten_tree(params).items():
        flat[k], name = _to_storage(leaf)
        if name is not None:
            extended[k] = name
    tmp = os.path.join(local, "params.npz.tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, os.path.join(local, "params.npz"))
    with open(os.path.join(local, "bundle.json"), "w") as f:
        json.dump({**model_config, "_param_dtypes": extended} if extended
                  else model_config, f, indent=2, sort_keys=True)
    return local


def load_bundle(export_dir: str) -> tuple[Any, dict]:
    """Load an exported bundle -> (params, model_config).  Leaves are numpy
    arrays, except extended-dtype leaves (bfloat16, float8), which are CPU
    tensors of the matching torch dtype."""
    local = resolve_uri(export_dir)
    with open(os.path.join(local, "bundle.json")) as f:
        config = json.load(f)
    extended = config.pop("_param_dtypes", {})
    npz = os.path.join(local, "params.npz")
    if not os.path.exists(npz):
        raise NotImplementedError(
            f"{export_dir} holds no params.npz: the orbax bundle layout "
            "(cross-process-sharded params) is not read by the port yet; "
            "re-export the bundle with fully addressable params")
    with np.load(npz) as data:
        flat = {k: data[k] for k in data.files}
    for k, name in extended.items():
        if name not in _EXTENDED_DTYPES:
            raise ValueError(f"bundle leaf {k!r} has dtype {name!r}, which the "
                             f"port cannot read (knows {sorted(_EXTENDED_DTYPES)})")
        storage, dtype = _EXTENDED_DTYPES[name]
        flat[k] = torch.from_numpy(flat[k].view(storage)).view(dtype)
    return _unflatten_tree(flat), config


def bundle_signature(export_dir: str) -> tuple:
    """Cheap change signature of an exported bundle: (name, mtime_ns, size)
    per bundle file.  ``export_bundle`` commits params.npz by atomic rename,
    so a changed signature is a complete newer export, never a torn one."""
    local = resolve_uri(export_dir)
    sig = []
    for name in ("bundle.json", "params.npz", "params"):
        try:
            st = os.stat(os.path.join(local, name))
        except OSError:
            continue
        sig.append((name, st.st_mtime_ns, st.st_size))
    return tuple(sig)


def _as_torch_dtype(dtype: Any) -> torch.dtype:
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros((), np.dtype(dtype))).dtype


def _program_ops(program) -> dict:
    """What ``program``'s graph needs beyond ``torch``: the operator
    ``tos::flash_attn_fwd`` if it calls it, the module that registers it,
    and the kernel routes (``ops.attention._route``) at the type and head
    dim of its calls, with the number of calls on each."""
    from tensorflowonspark_torch.ops import attention

    routes: dict = {}
    for node in program.graph.nodes:
        if node.op == "call_function" and node.target is torch.ops.tos.flash_attn_fwd.default:
            q = node.args[0].meta["val"]
            route = attention._route(q.dtype, q.shape[-1])
            routes[route] = routes.get(route, 0) + 1
    if not routes:
        return {"ops": [], "op_module": None, "op_routes": {}}
    return {"ops": [attention.OP_NAME], "op_module": attention.__name__,
            "op_routes": {attention.OP_NAME: [
                {"kernel": kernel, "padded_head_dim": padded, "nodes": n}
                for (kernel, padded), n in sorted(routes.items())]}}


def export_program(export_dir: str, params: Any, model_config: dict,
                   input_shape: tuple, input_dtype: Any = None, device=None,
                   batch_polymorphic: bool = True) -> str:
    """Serving interop: export a self-contained ``torch.export`` program,
    the counterpart of the JAX package's ``export_stablehlo``.

    The reference's SavedModel was consumable by anything speaking TF serving
    (``TFNode.py:~160-230``); the bundle format is registry-bound to this
    repo.  This writes ``model.pt2`` — the model's eval forward with the
    weights inside, through ``torch.export.export`` and
    ``torch.export.save`` — so a consumer needs no model registry:

        logits = torch.export.load("model.pt2").module()(images)

    A program that calls no operator of this package (``program.json``'s
    ``ops`` is ``[]``: the image and wide-and-deep families) needs only
    ``torch``.  A model that attends (the LM, the MoE LM) calls
    ``tos::flash_attn_fwd`` once per attention layer, on the card and on
    the CPU alike; the consumer imports ``op_module``
    (``tensorflowonspark_torch.ops.attention``, which registers it) before
    ``torch.export.load``.  That import loads the package's ``__init__``
    and the modules it imports (its cluster modules among them; the
    consumer in ``chip_smoke.py`` lists them), and builds nothing: on a CUDA
    tensor the op builds its kernel from the package's ``csrc/`` with
    ``nvcc`` at its first launch.  The JAX artifact carries its Mosaic
    kernel inline; a ``.pt2`` cannot carry CUDA code, so the kernel comes
    from that package.

    ``params`` is the bundle's tree (flax names, as ``export_bundle`` takes
    it).  ``input_shape`` excludes the batch dim when ``batch_polymorphic``
    (the default): the program then scores any batch size up to 65535 (a
    ``torch.export.Dim``), and a forward that needs a concrete batch
    raises here.  Otherwise ``input_shape`` is the whole example
    shape and the program takes only that shape (the MoE LM, whose
    expert capacity needs a concrete batch, exports only so, as in the
    JAX package).  ``device`` (default ``cuda``) is where the program's
    weights live and where it runs.  ``program.json`` beside it records
    the config, device, input shape and dtype, ``batch_polymorphic``, and
    the ops (``_program_ops``: each with its kernel route and padded head
    dim, and the number of its calls in the graph).
    """
    from tensorflowonspark_torch.convert import flax_to_torch
    from tensorflowonspark_torch.gpu_info import default_device
    from tensorflowonspark_torch.models.registry import build

    dev = default_device(device)
    with torch.device("meta"):
        model = build(model_config).cast_matrices_()
    model = model.to_empty(device=dev).eval()
    model.load_state_dict(flax_to_torch(params, model_config), strict=True)
    dtype = _as_torch_dtype(input_dtype)
    if batch_polymorphic:
        # a batch of 2: torch.export specialises a dimension it sees at 0
        # or 1.  A named Dim makes the export raise where the forward pins
        # the batch (the MoE's expert capacity) rather than write a program
        # that takes only the example's; its max is the largest batch
        # cuDNN's convolutions take on the card.
        example = torch.zeros((2, *input_shape), dtype=dtype, device=dev)
        dynamic = ({0: torch.export.Dim("batch", max=65535)},)
    else:
        example = torch.zeros(tuple(input_shape), dtype=dtype, device=dev)
        dynamic = None
    with torch.no_grad():
        program = torch.export.export(model, (example,), dynamic_shapes=dynamic)

    local = resolve_uri(export_dir)
    os.makedirs(local, exist_ok=True)
    torch.export.save(program, os.path.join(local, "model.pt2"))
    meta = {"model_config": model_config, "device": dev.type,
            "input_shape": list(input_shape),
            "input_dtype": str(dtype).removeprefix("torch."),
            "batch_polymorphic": batch_polymorphic, **_program_ops(program)}
    with open(os.path.join(local, "program.json"), "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)
    return local


_BUNDLE_CACHE: dict[str, tuple[Any, dict, Callable]] = {}
_BUNDLE_LOCK = tos_named_lock("checkpoint._bundle_lock")
# single-flight per export_dir: the loader-elect's event, waited on by every
# concurrent caller of the same key so N serving threads cost ONE load
_BUNDLE_LOADING: dict[str, threading.Event] = {}
# per-key invalidation generation: a load that STARTED before an
# invalidate_bundle call must not re-cache its (now stale) result after it
_BUNDLE_GEN: dict[str, int] = {}


def load_bundle_cached(export_dir: str, build_apply: Callable[[dict], Callable]) -> tuple[Any, dict, Callable]:
    """Per-process cached bundle load, single-flight: concurrent callers of
    the same ``export_dir`` share one load.  A failed load releases the key
    so the next caller retries.  ``invalidate_bundle`` is the hot-reload
    hook."""
    key = os.path.abspath(resolve_uri(export_dir))
    while True:
        with _BUNDLE_LOCK:
            hit = _BUNDLE_CACHE.get(key)
            if hit is not None:
                return hit
            pending = _BUNDLE_LOADING.get(key)
            if pending is None:
                _BUNDLE_LOADING[key] = threading.Event()
                gen = _BUNDLE_GEN.get(key, 0)
        if pending is not None:
            pending.wait()  # loader finished (or failed); re-check the cache
            continue
        try:
            params, config = load_bundle(export_dir)
            value = (params, config, build_apply(config))
            with _BUNDLE_LOCK:
                if _BUNDLE_GEN.get(key, 0) == gen:
                    _BUNDLE_CACHE[key] = value
                # else: invalidate_bundle ran while this load was reading the
                # OLD export files — hand the stale value to THIS caller but
                # never cache it, or the hot reload would be silently undone
            return value
        finally:
            with _BUNDLE_LOCK:
                done = _BUNDLE_LOADING.pop(key, None)
            if done is not None:
                done.set()


def invalidate_bundle(export_dir: str | None = None) -> None:
    """Drop cached bundle(s) so the next ``load_bundle_cached`` re-reads from
    disk; ``None`` clears the whole cache.  Loads already in flight return
    their results to their callers but do not cache them."""
    with _BUNDLE_LOCK:
        if export_dir is None:
            _BUNDLE_CACHE.clear()
            for key in _BUNDLE_LOADING:
                _BUNDLE_GEN[key] = _BUNDLE_GEN.get(key, 0) + 1
            return
        key = os.path.abspath(resolve_uri(export_dir))
        _BUNDLE_CACHE.pop(key, None)
        _BUNDLE_GEN[key] = _BUNDLE_GEN.get(key, 0) + 1


# ---------------------------------------------------------------------------
# Embedding shard checkpoints (sharded embedding tier)
#
# One logical table's rows are range-sharded across the training world; the
# full-tree checkpoints above never see them.  Each node instead commits its
# own resident range as a single npz under
#
#     <model_dir>/embed_<table>/step_<N>/shard_<lo>_<hi>.npz
#
# (atomic tmp-write + os.replace, matching export_bundle).  Restore is by
# RANGE, not by file: any requested [lo, hi) is reassembled from whatever
# shard files cover it, so a re-shard — eviction shrinking the world, a
# serve fleet sized differently from the train world — restores new bounds
# from old files without a repartition pass.
# ---------------------------------------------------------------------------


def _embed_step_dir(model_dir: str, table: str, step: int) -> str:
    return os.path.join(resolve_uri(model_dir), f"embed_{table}",
                        f"step_{int(step)}")


def save_embedding_shard(model_dir: str, table: str, step: int,
                         lo: int, hi: int, rows) -> str:
    """Atomically commit one shard's rows ``[lo, hi)`` at ``step``."""
    d = _embed_step_dir(model_dir, table, step)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"shard_{int(lo)}_{int(hi)}.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, lo=np.int64(lo), hi=np.int64(hi),
                 rows=np.ascontiguousarray(np.asarray(rows, np.float32)))
    os.replace(tmp, path)
    return path


def _embed_shard_files(model_dir: str, table: str,
                       step: int) -> list[tuple[int, int, str]]:
    """(lo, hi, path) triples at ``step``, sorted by lo; [] if none."""
    d = _embed_step_dir(model_dir, table, step)
    out = []
    try:
        names = os.listdir(d)
    except FileNotFoundError:
        return out
    for name in names:
        if not (name.startswith("shard_") and name.endswith(".npz")):
            continue
        try:
            lo_s, hi_s = name[len("shard_"):-len(".npz")].split("_")
            out.append((int(lo_s), int(hi_s), os.path.join(d, name)))
        except ValueError:
            continue
    out.sort()
    return out


def restore_embedding_shard(model_dir: str, table: str, step: int,
                            lo: int, hi: int, dim: int):
    """Reassemble the row range ``[lo, hi)`` from the shard files at
    ``step``.  Raises ``FileNotFoundError`` if the files present do not
    fully cover the range (a partial checkpoint must not restore silently)."""
    out = np.empty((int(hi) - int(lo), int(dim)), np.float32)
    need = int(lo)
    for f_lo, f_hi, path in _embed_shard_files(model_dir, table, step):
        if f_hi <= need or f_lo >= hi:
            continue
        if f_lo > need:
            break  # gap before this file — range not covered
        with np.load(path) as z:
            rows = z["rows"]
        take_lo, take_hi = need, min(f_hi, int(hi))
        out[take_lo - int(lo):take_hi - int(lo)] = \
            rows[take_lo - f_lo:take_hi - f_lo]
        need = take_hi
        if need >= hi:
            break
    if need < hi:
        raise FileNotFoundError(
            f"embedding checkpoint for table {table!r} step {step} covers "
            f"only up to row {need}, need [{lo}, {hi}) under {model_dir}")
    return out


def embedding_steps(model_dir: str, table: str) -> list[int]:
    """All step numbers with at least one shard file, ascending."""
    base = os.path.join(resolve_uri(model_dir), f"embed_{table}")
    steps = []
    try:
        names = os.listdir(base)
    except FileNotFoundError:
        return steps
    for name in names:
        if name.startswith("step_"):
            try:
                steps.append(int(name[len("step_"):]))
            except ValueError:
                continue
    steps.sort()
    return steps


def latest_embedding_step(model_dir: str, table: str) -> int | None:
    """Newest checkpointed step for ``table``, or None."""
    steps = embedding_steps(model_dir, table)
    return steps[-1] if steps else None
