"""Reading the JAX package's orbax checkpoints without orbax, tensorstore,
JAX or a zstd library: ``restore_tree(path)``.

An orbax checkpoint directory (written by the JAX package's
``save_checkpoint``, and by its ``export_bundle`` as ``<export_dir>/params``
for params sharded across processes) holds ``_METADATA`` — the tree's
structure, one entry per leaf — and the leaves as zarr v2 arrays
(``zarr2.py``), in an OCDBT database (``ocdbt.py``, the default) or, with
``use_ocdbt: false``, as plain files ``<name>/.zarray`` and
``<name>/<chunk>``.  Chunks are zstd frames, decoded by the package's own
decoder (``zstd.py``, built from ``zstd_decode.cc`` at first use).

The result is what the JAX package's host-side ``restore_checkpoint``
returns: nested dicts and lists (tuples come back as lists, as orbax
canonicalises them), leaves as numpy arrays (a Python or numpy scalar as a
0-d array), except bfloat16 and float8 leaves, which are CPU tensors of the
torch dtype.  Empty dicts, empty lists and ``None`` come back as such.
"""

from __future__ import annotations

import json
import os
from typing import Any

from tensorflowonspark_torch.orbax_layout.ocdbt import OcdbtStore
from tensorflowonspark_torch.orbax_layout.zarr2 import read_array

METADATA = "_METADATA"
_ARRAY_TYPES = ("np.ndarray", "jax.Array", "scalar")
_EMPTY = {"Dict": dict, "List": list, "None": lambda: None}
_DICT_KEY, _SEQUENCE_KEY = 2, 1  # orbax's key_type


def is_orbax_checkpoint(path: str) -> bool:
    return os.path.isfile(os.path.join(path, METADATA))


def _file_getter(root: str):
    def get(key: str) -> bytes | None:
        try:
            with open(os.path.join(root, *key.split("/")), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None
    return get


def _finish(node: Any) -> Any:
    """Containers built as dicts (``_Seq`` for sequences) -> dicts and lists."""
    if isinstance(node, _Seq):
        if sorted(node) != list(range(len(node))):
            raise ValueError(f"orbax: sequence indices {sorted(node)} are not 0..{len(node) - 1}")
        return [_finish(node[i]) for i in range(len(node))]
    if isinstance(node, dict):
        return {k: _finish(v) for k, v in node.items()}
    return node


class _Seq(dict):
    """A sequence while it is being filled: index -> child."""


def restore_tree(path: str) -> Any:
    """The tree of the orbax checkpoint directory ``path`` (module
    docstring).  Raises ``ValueError`` for what it cannot read (zarr3, an
    unknown value type), naming it."""
    with open(os.path.join(path, METADATA)) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError(f"orbax: {path} was written with use_zarr3: true; this reader "
                         "reads zarr v2")
    if meta.get("use_ocdbt", True):
        store = OcdbtStore(path)
        get = lambda key: store.read(key) if key in store else None  # noqa: E731
    else:
        get = _file_getter(path)
    root: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        value_type = entry["value_metadata"]["value_type"]
        if value_type in _ARRAY_TYPES:
            leaf = read_array(get, ".".join(str(k["key"]) for k in keys))
        elif value_type in _EMPTY:
            leaf = _EMPTY[value_type]()
        else:
            raise ValueError(f"orbax: {path} has a leaf of value_type {value_type!r}")
        node = root
        for depth, k in enumerate(keys):
            key = int(k["key"]) if k["key_type"] == _SEQUENCE_KEY else str(k["key"])
            if depth == len(keys) - 1:
                node[key] = leaf
            else:
                kind = _Seq if keys[depth + 1]["key_type"] == _SEQUENCE_KEY else dict
                node = node.setdefault(key, kind())
    return _finish(root)
