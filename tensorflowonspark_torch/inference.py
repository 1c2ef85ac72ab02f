"""Streaming inference map_funs — counterpart of
``tensorflowonspark_tpu/inference.py``.

``bundle_inference_loop`` is task-parallel: every node holds the whole
model and scores its own partitions, one result per input item, in order.
``sharded_bundle_inference_loop`` scores over one device mesh of the data
nodes: the model's parameters sharded over it, one forward of every rank
per round, each rank emitting its own rows.  Each feed batch is padded to
the static ``batch_size`` and the padding dropped before emission, so the
exactly-count invariant holds.
"""

from __future__ import annotations

import numpy as np
import torch


def _arg(args, name, default=None):
    if isinstance(args, dict):
        return args.get(name, default)
    return getattr(args, name, default)


def _stack_feature_column(values: list) -> np.ndarray:
    """Stack one column's rows, deciding the dtype per column: a column whose
    every row is a wide integer (>= 32-bit) keeps its integer dtype (token
    ids must not pass through float32); everything else becomes float32."""
    arrays = [np.asarray(v) for v in values]
    if all(a.dtype.kind in "iu" and a.dtype.itemsize >= 4 for a in arrays):
        return np.stack(arrays)
    return np.stack([a if a.dtype == np.float32 else a.astype(np.float32)
                     for a in arrays])


def rows_to_features(rows: list, input_mapping: dict | None) -> np.ndarray:
    """Stack mapped feature columns into one batch array.

    Row dicts with a multi-column ``input_mapping`` are concatenated on the
    trailing feature axis in mapping order (each column flattened to
    ``[B, -1]`` and cast to float32).  A single mapped column keeps its
    natural shape and its wide-integer dtype.  Non-dict rows are stacked
    directly.
    """
    if isinstance(rows[0], dict):
        if input_mapping:
            cols = list(input_mapping)
            missing = [c for c in cols if c not in rows[0]]
            if missing:
                raise KeyError(f"input_mapping columns {missing} not in row "
                               f"(have {sorted(rows[0])})")
        elif "features" in rows[0]:
            cols = ["features"]
        elif "image" in rows[0]:
            cols = ["image"]
        else:
            raise ValueError(
                f"cannot pick a feature column from {sorted(rows[0])}; set input_mapping"
            )
        arrays = [_stack_feature_column([r[c] for r in rows]) for c in cols]
        if len(arrays) == 1:
            return arrays[0]
        return np.concatenate(
            [(a if a.dtype == np.float32
              else a.astype(np.float32)).reshape(a.shape[0], -1)
             for a in arrays], axis=-1)
    return _stack_feature_column(rows)


def to_host(out):
    """A model output (tensor, or dict of tensors) as numpy on the host.
    For a CUDA tensor this waits for the device to finish it."""
    if isinstance(out, dict):
        return {k: to_host(v) for k, v in out.items()}
    if isinstance(out, torch.Tensor):
        t = out.detach().cpu()
        return (t.float() if t.dtype in (torch.bfloat16, torch.float16) else t).numpy()
    return np.asarray(out)


def batch_results(out, n: int, postprocess: str | None) -> list:
    """The first ``n`` rows of a host output as one result per row;
    ``postprocess="argmax"`` gives each row's class id (an int), or for a
    sequence model's ``[B, S, V]`` logits each row's ``[S]`` ids."""
    if isinstance(out, dict):
        if postprocess == "argmax":
            raise ValueError("postprocess='argmax' needs a single-output "
                             "model; this bundle emits named outputs "
                             f"{sorted(out)}")
        cols = {k: np.asarray(v)[:n] for k, v in out.items()}
        return [{k: v[i] for k, v in cols.items()} for i in range(n)]
    preds = np.asarray(out)[:n]
    if postprocess == "argmax":
        return [int(p) if np.ndim(p) == 0 else p for p in preds.argmax(axis=-1)]
    return list(preds)


# the mesh axes other than the batch axes: ranks that differ only along
# them compute on the same rows
_PEER_AXES = ("tp", "sp", "ep", "pp")


def _peer_batch(mesh, batch) -> torch.Tensor:
    """The batches of this rank's peers (the ranks that differ from it only
    off the batch axes, ``tp``) concatenated in peer order on the mesh's
    device: they compute on the same rows, so each of them scores them all
    and keeps its own (``_local_rows``).  ``make_batch_iterator(mesh=)``
    would instead broadcast the first peer's batch, which suits training
    but would drop the other peers' streamed rows here."""
    from tensorflowonspark_torch.parallel.mesh import device_of, group
    from tensorflowonspark_torch.parallel.tp import gather_from

    x = torch.as_tensor(batch).to(device_of(mesh))
    return gather_from(x, 0, group(mesh, *_PEER_AXES))


def _local_rows(out, mesh):
    """This rank's rows of a forward over its peers' concatenated batches
    (``_peer_batch``), in order: the block at its index among the peers.
    Every peer holds the whole output; taking each its own block keeps a
    row from coming out twice (the JAX package dedupes addressable shards
    by batch offset for the same reason)."""
    from tensorflowonspark_torch.parallel.mesh import axis_index, axis_size

    if isinstance(out, dict):
        return {k: _local_rows(v, mesh) for k, v in out.items()}
    n = axis_size(mesh, *_PEER_AXES)
    return out if n == 1 else out.chunk(n)[axis_index(mesh, *_PEER_AXES)]


def sharded_bundle_inference_loop(args, ctx) -> None:
    """map_fun: model-parallel STREAMING inference over one mesh of the
    data nodes (``run(torch_distributed=True)``, one device per node).

    ``bundle_inference_loop`` is task-parallel: every node holds the whole
    model.  Here the model's parameters are sharded over
    ``ctx.make_mesh(**mesh_axes)`` (``tp.shard_model``: ``fsdp`` blocks
    gathered at each use, ``tp`` heads), every round is one forward of
    every rank over its rows, and each rank emits predictions for its OWN
    streamed rows only, so the ordered exactly-count contract holds end to
    end.  Rounds run in lockstep (``make_batch_iterator`` with ``ctx``):
    a rank whose share ran out joins with filler batches (``n == 0``),
    whose forward still runs — the fsdp gathers are collectives — and
    emits nothing.

    Args: ``export_dir`` (bundle), ``batch_size`` (per node), optional
    ``mesh_axes`` (default ``{"fsdp": -1}``: parameters sharded over every
    node; batch axes and ``tp`` only), ``postprocess``/``input_mapping`` as
    in ``bundle_inference_loop``, ``device`` (default ``cuda``).

    Driver contract: ``cluster.inference(..., eof_when_done=True)`` (a
    node whose share ran out must learn it is done while its peers still
    score) and at least one partition per data node; ``TorchModel.
    transform(scoring="sharded")`` does both.
    """
    from tensorflowonspark_torch.checkpoint import load_bundle
    from tensorflowonspark_torch.convert import flax_to_torch
    from tensorflowonspark_torch.models.registry import build
    from tensorflowonspark_torch.parallel import dp as dplib
    from tensorflowonspark_torch.parallel.mesh import axis_size, device_of, is_multiprocess
    from tensorflowonspark_torch.parallel.tp import shard_model

    export_dir = _arg(args, "export_dir")
    if not export_dir:
        raise ValueError("sharded_bundle_inference_loop requires args.export_dir")
    batch_size = int(_arg(args, "batch_size", 64) or 64)
    postprocess = _arg(args, "postprocess")
    input_mapping = _arg(args, "input_mapping")
    mesh_axes = dict(_arg(args, "mesh_axes") or {"fsdp": -1})

    mesh = ctx.make_mesh(_arg(args, "device"), **mesh_axes)
    if axis_size(mesh, "sp", "ep", "pp") > 1:
        raise ValueError(f"sharded scoring splits the batch axes and tp; got {mesh_axes}")
    variables, config = load_bundle(export_dir)
    with torch.device("meta"):
        model = build(config).cast_matrices_()
    model = model.to_empty(device=device_of(mesh)).eval()
    model.load_state_dict(flax_to_torch(variables, config), strict=True)
    shard_model(model, mesh)  # every node loaded the same bundle
    feed = ctx.get_data_feed(train_mode=False)
    for batch, n in dplib.make_batch_iterator(
            feed, batch_size, lambda items: rows_to_features(items, input_mapping),
            ctx=ctx, lockstep=is_multiprocess(mesh)):
        with torch.inference_mode():
            out = _local_rows(model(_peer_batch(mesh, batch)), mesh)
        if not n:
            continue  # filler round: joined the collectives, nothing to emit
        feed.batch_results(batch_results(to_host(out), n, postprocess))


def bundle_inference_loop(args, ctx) -> None:
    """map_fun: score the stream with the bundle at ``args.export_dir``.

    Emits one prediction per input item, in order.  Optional args:
    ``batch_size`` (default 64), ``postprocess`` ("argmax" for int class
    ids), ``input_mapping`` (see ``rows_to_features``), ``device`` (default
    ``cuda``; raises without a card unless ``"cpu"`` is asked for).
    """
    import functools

    from tensorflowonspark_torch.checkpoint import load_bundle_cached
    from tensorflowonspark_torch.models.registry import build_apply

    export_dir = _arg(args, "export_dir")
    if not export_dir:
        raise ValueError("bundle_inference_loop requires args.export_dir")
    batch_size = int(_arg(args, "batch_size", 64) or 64)
    postprocess = _arg(args, "postprocess")
    input_mapping = _arg(args, "input_mapping")
    builder = functools.partial(build_apply, device=_arg(args, "device"))

    variables, _config, apply_fn = load_bundle_cached(export_dir, builder)
    feed = ctx.get_data_feed(train_mode=False)
    while not feed.should_stop():
        items = feed.next_batch(batch_size)
        if not items:
            continue
        n = len(items)
        padded = list(items) + [items[-1]] * (batch_size - n)
        out = to_host(apply_fn(variables, rows_to_features(padded, input_mapping)))
        feed.batch_results(batch_results(out, n, postprocess))
