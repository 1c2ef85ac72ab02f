"""Node-side resident serving map_fun — counterpart of
``tensorflowonspark_tpu/serving/loop.py``.

Each serving replica runs this loop: load the bundle once (through the
process-wide single-flight cache), then answer micro-batches streamed in by
the gateway's router over the node's data feed — one round per batch, one
result per input row, in order.

- Every batch is padded to the static ``max_batch`` shape, as the gateway
  pads it, so the model always sees one batch shape.
- Control items (``{CTL_KEY: "reload" | "ping" | ...}``) ride the same
  stream as one-item rounds and are acked with a one-item result, so the
  exactly-count invariant holds for them too.  A ``reload`` invalidates the
  bundle cache entry and reloads (optionally from the ``export_dir`` the
  item carries, marking the bundle a rollout ``candidate``); the ack echoes
  the active export_dir and its on-disk bundle signature.

A bundle whose config carries a ``sharded_embedding`` block (the sharded
wide-and-deep export) keeps its table outside the bundle: the replica loads
its own range of the table, answers the router's id lookups on the
``embed``/``embed_out`` queue pair from a responder thread, and scores
``sharded_batch`` control rounds (raw rows plus the rows the router
gathered) with the dense half of the model.

Termination is the standard feed contract: ``EndOfFeed`` or the driver's
stop signal ends the loop.
"""

from __future__ import annotations

import functools
import time

import numpy as np


def serving_loop(args, ctx) -> None:
    """map_fun: serve micro-batches with the bundle at ``args.export_dir``.

    Args: ``export_dir`` (required), ``max_batch`` (static batch shape;
    default ``TOS_SERVE_MAX_BATCH``), ``postprocess`` ("argmax" for int
    class ids), ``input_mapping`` (see ``inference.rows_to_features``),
    ``device`` (default ``cuda``; raises without a card unless ``"cpu"`` is
    asked for).
    """
    from tensorflowonspark_torch import faultinject
    from tensorflowonspark_torch.checkpoint import (
        bundle_signature,
        invalidate_bundle,
        load_bundle_cached,
    )
    from tensorflowonspark_torch.inference import (
        _arg,
        batch_results,
        rows_to_features,
        to_host,
    )
    from tensorflowonspark_torch.models.registry import build_apply
    from tensorflowonspark_torch.serving.batcher import CTL_KEY
    from tensorflowonspark_torch.telemetry import trace as ttrace
    from tensorflowonspark_torch.utils.envtune import env_int

    export_dir = _arg(args, "export_dir")
    if not export_dir:
        raise ValueError("serving_loop requires args.export_dir")
    max_batch = (int(_arg(args, "max_batch", 0) or 0)
                 or env_int("TOS_SERVE_MAX_BATCH", 64))
    postprocess = _arg(args, "postprocess")
    input_mapping = _arg(args, "input_mapping")
    builder = functools.partial(build_apply, device=_arg(args, "device"))

    variables, config, apply_fn = load_bundle_cached(export_dir, builder)
    # sharded-embedding bundles: load THIS replica's range of the table
    # (re-sharded over the serve world) and the dense-half apply, and answer
    # the router's lookup fan-out on the embed queue pair from a responder
    # thread.  Scoring batches then arrive as one-item `sharded_batch`
    # control rounds carrying the rows the router already gathered.
    embed_shard = None
    sharded_apply = None
    if config.get("sharded_embedding"):
        import threading

        from tensorflowonspark_torch.embedding.serve import (
            build_sharded_apply,
            embed_responder_loop,
            load_serving_shard,
        )

        _, embed_shard = load_serving_shard(
            export_dir, config["sharded_embedding"], ctx.executor_id,
            ctx.num_executors)
        sharded_apply = build_sharded_apply(config, device=_arg(args, "device"))
        threading.Thread(
            target=embed_responder_loop, args=(ctx, embed_shard),
            daemon=True, name=f"embed-responder-{ctx.executor_id}").start()
    # True while this replica serves a rollout CANDIDATE bundle (set by the
    # reload ctl's `candidate` bit): the bad_model chaos hook fires only then
    serving_candidate = False
    batches = ctx.metrics.counter("serve.node_batches")
    rows_served = ctx.metrics.counter("serve.node_rows")
    feed = ctx.get_data_feed(train_mode=False)
    while not feed.should_stop():
        items = feed.next_batch(max_batch)
        if not items:
            continue
        if len(items) == 1 and isinstance(items[0], dict) and CTL_KEY in items[0]:
            op = items[0][CTL_KEY]
            if op == "sharded_batch":
                # one wrapped scoring batch: raw rows + the fused-table rows
                # the router's fan-out gathered; one result item back keeps
                # the exactly-count invariant (the router unwraps it)
                rows = items[0]["rows"]
                emb = np.asarray(items[0]["emb"], np.float32)
                with ctx.metrics.timed("serve.node_batch_secs"), \
                        ttrace.span("serve.node_compute",
                                    parent=getattr(feed, "last_trace", None)):
                    x = rows_to_features(list(rows), input_mapping)
                    out = to_host(sharded_apply(variables, x, emb))
                batches.inc()
                rows_served.inc(len(rows))
                feed.batch_results([{CTL_KEY: "sharded_results",
                                     "results": batch_results(out, len(rows),
                                                              postprocess)}],
                                   chunk=True)
                continue
            if op == "reload":
                export_dir = str(items[0].get("export_dir") or export_dir)
                serving_candidate = bool(items[0].get("candidate"))
                invalidate_bundle(export_dir)
                variables, config, apply_fn = load_bundle_cached(export_dir, builder)
                if embed_shard is not None and config.get("sharded_embedding"):
                    # newer export: swap the resident range in place (the
                    # responder thread reads shard.rows, so the swap is
                    # visible to in-flight lookups atomically per request)
                    _, fresh = load_serving_shard(
                        export_dir, config["sharded_embedding"],
                        ctx.executor_id, ctx.num_executors)
                    embed_shard.rows = fresh.rows
                    sharded_apply = build_sharded_apply(
                        config, device=_arg(args, "device"))
                ctx.metrics.counter("serve.node_reloads").inc()
                feed.batch_results([{CTL_KEY: "reloaded",
                                     "export_dir": export_dir,
                                     "signature": bundle_signature(export_dir)}])
            elif op == "ping":
                # echo the nonce: the router's resync matches ITS pong
                feed.batch_results([{CTL_KEY: "pong",
                                     "nonce": items[0].get("nonce")}])
            else:
                feed.batch_results([{CTL_KEY: f"unknown:{op}"}])
            continue
        n = len(items)
        padded = list(items) + [items[-1]] * (max_batch - n)
        # The span closes only once the result is on the host: CUDA runs
        # asynchronously, so a span around the call alone would time the
        # launches, not the device work.
        with ctx.metrics.timed("serve.node_batch_secs"), \
                ttrace.span("serve.node_compute",
                            parent=getattr(feed, "last_trace", None)):
            x = rows_to_features(padded, input_mapping)
            out = to_host(apply_fn(variables, x))
            corrupt, delay = faultinject.bad_model(serving_candidate)
            if delay:
                time.sleep(delay)
            if corrupt:
                # injected model regression: candidate outputs go NaN
                out = ({k: np.full_like(np.asarray(v, dtype=float), np.nan)
                        for k, v in out.items()}
                       if isinstance(out, dict)
                       else np.full_like(np.asarray(out, dtype=float), np.nan))
        results = batch_results(out, n, postprocess)
        batches.inc()
        rows_served.inc(n)
        # one ResultChunk = one queue put + one collect round-trip per batch
        feed.batch_results(results, chunk=True)
