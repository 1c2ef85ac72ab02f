"""Serving-side sharded embeddings: export, replica shards, lookup responder.

A sharded-table training job cannot export one ``params.npz`` — no process
ever holds the whole table.  Instead each training node commits its final
shard range into the export directory via the embedding-shard checkpoint
layout (``embed_<table>/step_<N>/shard_<lo>_<hi>.npz``) and the chief
writes the ordinary dense bundle whose config carries a
``"sharded_embedding"`` block naming the table geometry and final step.

At serve time the shards are RESIDENT on the gateway's replicas, re-sharded
over the serve world (which need not equal the train world — restore
reassembles any range from the committed files):

- each replica loads the dense bundle plus ITS range
  (:func:`load_serving_shard`) and runs a lookup responder thread on the
  dedicated ``embed``/``embed_out`` queue pair
  (:func:`embed_responder_loop`);
- the gateway's router fans per-owner unique-id lookup sub-requests to the
  responders, assembles the gathered rows, and ships the scoring replica
  one ``sharded_batch`` control item = raw rows + gathered fused-table
  rows; the replica applies the DENSE model (:func:`build_sharded_apply`,
  on the replica's device)
  and answers with one result item, preserving the data plane's
  exactly-count invariant.

The serve cluster must be started with the extra queues:
``cluster.run(serving_loop, args, queues=("input", "output", "error",
"embed", "embed_out"))``.
"""

from __future__ import annotations

import logging
from typing import Callable

import numpy as np

from tensorflowonspark_torch.embedding.sharding import EmbeddingShard, ShardPlan

logger = logging.getLogger(__name__)

# queue pair the lookup responders listen on (distinct from the scoring
# "input"/"output" pair: lookups from the router's fan-out must never
# interleave with batch rounds or the exactly-count collection breaks)
EMBED_QNAME_IN = "embed"
EMBED_QNAME_OUT = "embed_out"


def sharded_config_block(plan: ShardPlan, step: int) -> dict:
    """The ``"sharded_embedding"`` bundle-config block (geometry + the
    final checkpoint step the export committed)."""
    return {"name": plan.name, "total_rows": plan.total_rows,
            "dim": plan.dim, "step": int(step)}


def export_sharded_shard(export_dir: str, plan: ShardPlan, rank: int,
                         rows: np.ndarray, step: int) -> str:
    """One training node's half of a sharded export: commit its resident
    rows into the export dir under the shard-checkpoint layout."""
    from tensorflowonspark_torch.checkpoint import save_embedding_shard

    lo, hi = plan.range_of(rank)
    return save_embedding_shard(export_dir, plan.name, step, lo, hi, rows)


def load_serving_shard(export_dir: str, block: dict, rank: int,
                       world: int) -> tuple[ShardPlan, EmbeddingShard]:
    """Load one serve replica's resident range: the train-time table
    re-sharded over the SERVE world (range reassembly makes train world !=
    serve world a non-event)."""
    from tensorflowonspark_torch.checkpoint import restore_embedding_shard

    plan = ShardPlan.even(str(block["name"]), int(block["total_rows"]),
                          int(block["dim"]), int(world))
    lo, hi = plan.range_of(rank)
    rows = restore_embedding_shard(export_dir, plan.name, int(block["step"]),
                                   lo, hi, plan.dim)
    return plan, EmbeddingShard(plan, rank, rows)


def make_id_fn(config: dict) -> Callable:
    """Model-specific ``features -> [B, C] int64 table ids`` extractor for
    the router's fan-out, from the bundle config (the wide-and-deep family
    shares one fused-table id scheme: per-column mod + disjoint offsets)."""
    model = str(config.get("model", ""))
    if model in ("wide_deep", "wide_deep_dense"):
        from tensorflowonspark_torch.models.wide_deep import (
            flat_categorical_ids,
        )

        vocab = int(config.get("vocab_size", 100_003))
        return lambda feats: flat_categorical_ids(
            np.asarray(feats, np.float32), vocab)
    raise ValueError(
        f"model {model!r} has no sharded-embedding id extractor")


def build_sharded_apply(config: dict, device=None) -> Callable:
    """``apply(variables, x, rows)`` for the dense half of a sharded model
    (``build_apply``'s single-x contract can't carry the gathered rows; the
    ``sharded_batch`` handler in ``serving_loop`` calls this).

    ``variables`` is the bundle's dense tree in the JAX package's layout;
    like ``registry.build_apply``, the first call with a tree loads it onto
    ``device`` (default ``cuda``; raises without a card) and later calls
    with the same tree reuse it.  The model runs in ``eval()`` under
    ``torch.inference_mode()``; ``x`` and ``rows`` may be numpy."""
    import torch

    from tensorflowonspark_torch.convert import flax_to_torch
    from tensorflowonspark_torch.gpu_info import default_device
    from tensorflowonspark_torch.models.registry import build

    dev = default_device(device)
    with torch.device("meta"):
        model = build(config).cast_matrices_()
    model = model.to_empty(device=dev).eval()
    loaded: list = [None]  # the tree whose weights the model holds

    def apply_fn(variables, x, rows):
        if loaded[0] is not variables:
            model.load_state_dict(flax_to_torch(variables, config), strict=True)
            loaded[0] = variables
        with torch.inference_mode():
            return model(torch.as_tensor(x, device=dev),
                         torch.as_tensor(rows, device=dev))

    apply_fn.model = model
    return apply_fn


def embed_responder_loop(ctx, shard: EmbeddingShard) -> None:
    """Thread body: answer id-lookup sub-requests on the embed queue pair.

    Each router fan-out round is one item ``{"ids": <int64 array>}`` and
    expects exactly one result ``{"ids": ids, "rows": resident rows}``; the
    loop answers item-for-item in order, so coalesced rounds from several
    concurrent fan-outs still collect exactly-count.  EOF on the ``embed``
    queue (node shutdown puts EOF on every input queue) ends the loop.
    """
    feed = ctx.get_data_feed(train_mode=False, qname_in=EMBED_QNAME_IN,
                             qname_out=EMBED_QNAME_OUT)
    lookups = ctx.metrics.counter("serve.embed_lookups")
    rows_out = ctx.metrics.counter("serve.embed_rows")
    while not feed.should_stop():
        items = feed.next_batch(64)
        if not items:
            continue
        results = []
        for item in items:
            ids = np.asarray(item.get("ids"), dtype=np.int64).reshape(-1)
            rows = shard.lookup(ids)
            results.append({"ids": ids, "rows": rows})
            rows_out.inc(int(ids.size))
        lookups.inc(len(results))
        feed.batch_results(results, chunk=True)
