"""Inference bundles — the bundle half of ``tensorflowonspark_tpu/checkpoint.py``.

A bundle is a directory holding ``params.npz`` (the flat param tree, keys
``a/b/c``, committed by atomic rename) and ``bundle.json`` (the model
config).  The format is shared with the JAX package: each side reads the
other's bundles.  16-bit and 8-bit float leaves that numpy cannot name
(bfloat16, float8) ride as raw bytes with their dtype names under the
reserved ``_param_dtypes`` key of ``bundle.json``; the port reads them as
unsigned integers viewed as the torch dtype, so it needs no ``ml_dtypes``.

The orbax bundle layout (a ``params/`` checkpoint directory, written by the
JAX package for cross-process-sharded params) is not read by the port yet.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Callable

import numpy as np
import torch

from tensorflowonspark_torch.utils.locks import tos_named_lock
from tensorflowonspark_torch.utils.paths import resolve_uri

# ml_dtypes name -> (numpy storage type, torch dtype)
_EXTENDED_DTYPES = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}
_TORCH_TO_EXTENDED = {t: (name, st) for name, (st, t) in _EXTENDED_DTYPES.items()}


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
