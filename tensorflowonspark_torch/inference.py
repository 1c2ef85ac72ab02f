"""Streaming inference map_fun — counterpart of
``tensorflowonspark_tpu/inference.py`` (task-parallel half).

Every node holds the whole model and scores its own partitions: one result
per input item, in order.  Each feed batch is padded to the static
``batch_size`` and the padding dropped before emission, so the
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
    """The first ``n`` rows of a host output as one result per row."""
    if isinstance(out, dict):
        if postprocess == "argmax":
            raise ValueError("postprocess='argmax' needs a single-output "
                             "model; this bundle emits named outputs "
                             f"{sorted(out)}")
        cols = {k: np.asarray(v)[:n] for k, v in out.items()}
        return [{k: v[i] for k, v in cols.items()} for i in range(n)]
    preds = np.asarray(out)[:n]
    if postprocess == "argmax":
        return [int(p) for p in preds.argmax(axis=-1)]
    return list(preds)


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
