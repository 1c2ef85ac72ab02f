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

**Inference bundles.**  A bundle is a directory holding ``params.npz`` (the
flat param tree, keys ``a/b/c``, committed by atomic rename) and
``bundle.json`` (the model config).  The format is shared with the JAX
package: each side reads the other's bundles.  16-bit and 8-bit float
leaves that numpy cannot name (bfloat16, float8) ride as raw bytes with
their dtype names under the reserved ``_param_dtypes`` key of
``bundle.json``; the port reads them as unsigned integers viewed as the
torch dtype, so it needs no ``ml_dtypes``.

The orbax bundle layout (a ``params/`` checkpoint directory, written by the
JAX package for cross-process-sharded params) is not read by the port yet.
"""

from __future__ import annotations

import copy
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


def save_checkpoint(path: str, tree: Any, force: bool = True,
                    async_save: bool = False) -> str:
    """Save a tree checkpoint to a (possibly hdfs://-mapped) path.

    The tree is snapshotted to host memory before this returns.  With
    ``async_save=True`` a background thread commits it, once the save
    before it has committed (one save in flight: the keep-newest window
    counts on that); call ``wait_for_saves()`` (or
    ``CheckpointManager.wait()``) before reading it back.
    ``force=False`` refuses to replace an existing checkpoint at ``path``.
    """
    global _IN_FLIGHT
    local = os.path.abspath(resolve_uri(path))
    if not force and os.path.exists(local):
        raise FileExistsError(f"checkpoint {path} exists (force=False)")
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
    """
    local = os.path.abspath(resolve_uri(path))
    raw = _unsnapshot(torch.load(os.path.join(local, _TREE_FILE),
                                 map_location="cpu", weights_only=True))
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
    """Multi-node save coordination, host-local regime: every process holds
    full values (the port has no state sharded across processes yet), so
    executor 0 saves and waits for the commit, then every data node meets
    at a barrier.  N nodes writing the same bytes would race on the commit
    rename.  The barrier releases only after the save has committed, so a
    node that crashes right after this call can still restart from the step
    just written.

    The reference's second regime, a collective save of state sharded across
    processes, comes with ROADMAP.md queue 1 (e) (DTensor/FSDP2).
    """
    if ctx.executor_id == 0:
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
