"""ML pipeline layer — the ``TFEstimator``/``TFModel`` replacement, the
port of ``tensorflowonspark_tpu/pipeline.py`` (``TorchParams``,
``TorchEstimator`` and ``TorchModel`` for its ``TPUParams``,
``TorchEstimator`` and ``TorchModel``).

Reference (``tensorflowonspark/pipeline.py``, ~780 LoC): pyspark.ml
``Estimator``/``Model`` subclasses with ~20 ``Has*`` Param mixins
(``:~40-300``), ``Namespace``/``TFParams`` argv merging (``:~300-380``),
``TFEstimator._fit`` = write TFRecords → ``TFCluster.run`` → ``train`` →
``shutdown`` → ``TFModel`` (``:~400-500``), and ``TFModel._transform`` =
per-executor cached SavedModel scoring with input/output column mappings
(``:~500-700``).

Design: no pyspark dependency — a small chainable Params system with the
same ``setX``/``getX`` surface; datasets are ``PartitionedDataset``s of
row-dicts; the model artifact is a bundle (param tree + model-registry
config, ``checkpoint.export_bundle``) instead of a SavedModel; transform
batches rows through one apply per node process (on the node's ``device``
argument, default ``cuda``) with the same cached-load behaviour the
reference used for its per-executor SavedModel singleton.

``scoring="sharded"`` scores over one device mesh of the data nodes
(``inference.sharded_bundle_inference_loop``; set ``torch_distributed``).
"""

from __future__ import annotations

import copy
import logging
import os
from typing import Any, Callable

import numpy as np

from tensorflowonspark_torch import cluster as _cluster
from tensorflowonspark_torch import dfutil
from tensorflowonspark_torch.cluster import InputMode
from tensorflowonspark_torch.data import PartitionedDataset, as_partitioned

logger = logging.getLogger(__name__)


# -- params system (reference Has* mixins, pipeline.py:~40-300) ---------------

class Param:
    """One declared parameter (name, default, doc)."""

    def __init__(self, name: str, default: Any = None, doc: str = ""):
        self.name = name
        self.default = default
        self.doc = doc

    def __repr__(self) -> str:
        return f"Param({self.name!r}, default={self.default!r})"


class Params:
    """Declared-parameter container with chainable setters.

    Mirrors the pyspark.ml Params surface the reference exposed
    (``getBatchSize``/``setBatchSize`` …) without the pyspark dependency.
    """

    def __init__(self, **kwargs: Any):
        self._values: dict[str, Any] = {}
        for k, v in kwargs.items():
            self.set(k, v)

    @classmethod
    def params(cls) -> dict[str, Param]:
        out: dict[str, Param] = {}
        for klass in reversed(cls.__mro__):
            for v in vars(klass).values():
                if isinstance(v, Param):
                    out[v.name] = v
        return out

    def set(self, name: str, value: Any) -> "Params":
        if name not in self.params():
            raise KeyError(f"unknown param {name!r}; declared: {sorted(self.params())}")
        self._values[name] = value
        return self

    def get(self, name: str) -> Any:
        if name in self._values:
            return self._values[name]
        return self.params()[name].default

    def is_set(self, name: str) -> bool:
        return name in self._values

    def explain_params(self) -> str:
        lines = []
        for name, p in sorted(self.params().items()):
            mark = "(set)" if self.is_set(name) else "(default)"
            lines.append(f"{name}: {p.doc} {mark} = {self.get(name)!r}")
        return "\n".join(lines)

    def copy(self) -> "Params":
        c = copy.copy(self)
        c._values = dict(self._values)
        return c

    def __getattr__(self, attr: str) -> Any:
        # setBatchSize(v) / getBatchSize() accessor synthesis (camelCase →
        # the snake_case param names used internally)
        if attr.startswith(("set", "get")) and len(attr) > 3:
            import re

            params = self.params()
            name = re.sub(r"(?<!^)(?=[A-Z])", "_", attr[3:]).lower()
            if name not in params:
                # Acronym accessors: naive camelCase splitting turns
                # setTFRecordDir into "t_f_record_dir" and the accessor the
                # reference API promises raises AttributeError.  Match by
                # underscore-insensitive normalization instead, so ANY
                # camelization of a declared param resolves (TFRecordDir ->
                # "tfrecorddir" == "tfrecord_dir" normalized).
                norm = attr[3:].lower()
                name = next((p for p in params if p.replace("_", "") == norm),
                            name)
            if name in params:
                if attr.startswith("set"):
                    return lambda value: self.set(name, value)
                return lambda: self.get(name)
        raise AttributeError(attr)

    def to_namespace(self) -> "Namespace":
        ns = {name: self.get(name) for name in self.params()}
        return Namespace(ns)


class HasBatchSize(Params):
    batch_size = Param("batch_size", 64, "per-step global batch size")


class HasEpochs(Params):
    epochs = Param("epochs", 1, "number of passes over the training data")


class HasSteps(Params):
    steps = Param("steps", -1, "max training steps (-1 = until data exhausted)")


class HasInputMapping(Params):
    input_mapping = Param("input_mapping", None, "dict: row column -> model input")


class HasOutputMapping(Params):
    output_mapping = Param("output_mapping", None, "dict: model output -> result column")


class HasInputMode(Params):
    input_mode = Param("input_mode", InputMode.STREAMING, "DIRECT (files) or STREAMING (feed)")


class HasMasterNode(Params):
    master_node = Param("master_node", None, "name of the chief role")


class HasNumExecutors(Params):
    num_executors = Param("num_executors", 1, "number of node processes/hosts")


class HasModelDir(Params):
    model_dir = Param("model_dir", None, "checkpoint directory (hdfs:// ok)")


class HasExportDir(Params):
    export_dir = Param("export_dir", None, "bundle export directory (hdfs:// ok)")


class HasTFRecordDir(Params):
    tfrecord_dir = Param("tfrecord_dir", None,
                         "stage the train dataset as TFRecords here before training")


class HasTensorboard(Params):
    tensorboard = Param("tensorboard", False, "spawn TensorBoard on the chief")


class HasLogDir(Params):
    log_dir = Param("log_dir", "", "node log/summary directory")


class HasReaders(Params):
    readers = Param("readers", 1, "per-node reader threads (DIRECT mode)")


class HasFeedTimeout(Params):
    feed_timeout = Param("feed_timeout", None,
                         "seconds before a stalled feed errors "
                         "(default: TOS_FEED_TIMEOUT env or 600)")


class HasShuffleSeed(Params):
    shuffle_seed = Param("shuffle_seed", None,
                         "per-epoch partition shuffle seed (STREAMING mode)")


class HasReservationTimeout(Params):
    reservation_timeout = Param("reservation_timeout", None,
                                "seconds to wait for all nodes to register "
                                "(default: TOS_RESERVATION_TIMEOUT env or 120)")


class HasTorchDistributed(Params):
    torch_distributed = Param("torch_distributed", False,
                              "form one torch.distributed process group over "
                              "the cluster's data nodes")


class HasModelConfig(Params):
    model_config = Param("model_config", None,
                         "model registry config dict passed through to the "
                         "train_fn as args.model_config (e.g. {'model': "
                         "'wide_deep', 'vocab_size': 1009}) — the plumbing "
                         "that keeps test/serve table sizes off the "
                         "full-width wide_deep defaults")


class HasTrainMode(Params):
    train_mode = Param("train_mode", "async",
                       "cluster.train feeding mode: 'async' (independent "
                       "drains) or 'sync' (lockstep epochs + sync manifest "
                       "block for collective train_fns)")
    embedding_plan = Param("embedding_plan", None,
                           "sharded-embedding plan manifest (ShardPlan or "
                           "its to_manifest() dict) published to the nodes "
                           "via the sync manifest block; requires "
                           "train_mode='sync'")


class HasScoring(Params):
    scoring = Param("scoring", "task",
                    "transform execution mode: 'task' (every node holds the "
                    "whole model, scores its own partitions) or 'sharded' "
                    "(model sharded over one mesh of the data nodes, "
                    "each node scoring its own rows; needs torch_distributed)")
    mesh_axes = Param("mesh_axes", None,
                      "mesh layout for scoring='sharded' "
                      "(default {'fsdp': -1})")


class Namespace:
    """Attribute-style argv bag (reference ``Namespace``, pipeline.py:~300-380).

    Merges dicts / argparse namespaces / other Namespaces; later sources win.
    """

    def __init__(self, *sources: Any):
        self.__dict__["_d"] = {}
        for s in sources:
            self.merge(s)

    def merge(self, source: Any) -> "Namespace":
        if source is None:
            return self
        if isinstance(source, Namespace):
            self._d.update(source._d)
        elif isinstance(source, dict):
            self._d.update(source)
        else:  # argparse.Namespace or any attr bag
            self._d.update(vars(source))
        return self

    def __getattr__(self, name: str) -> Any:
        try:
            return self.__dict__["_d"][name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        self._d[name] = value

    def __contains__(self, name: str) -> bool:
        return name in self._d

    def get(self, name: str, default: Any = None) -> Any:
        return self._d.get(name, default)

    def asdict(self) -> dict:
        return dict(self._d)

    def __repr__(self) -> str:
        return f"Namespace({self._d!r})"


class TorchParams(HasBatchSize, HasEpochs, HasSteps, HasInputMapping,
                  HasOutputMapping, HasInputMode, HasMasterNode, HasNumExecutors,
                  HasModelDir, HasExportDir, HasTFRecordDir, HasTensorboard,
                  HasLogDir, HasReaders, HasFeedTimeout, HasReservationTimeout,
                  HasShuffleSeed, HasTorchDistributed, HasScoring,
                  HasModelConfig, HasTrainMode):
    """All framework params in one mixin stack (reference ``TFParams``)."""

    def merge_args_params(self, tf_args: Any = None) -> Namespace:
        """Params-over-args merge the reference did before ``TFCluster.run``."""
        ns = Namespace(tf_args)
        for name in self.params():
            if self.is_set(name) or name not in ns:
                ns.merge({name: self.get(name)})
        return ns


# -- estimator (reference TFEstimator, pipeline.py:~400-500) ------------------

class TorchEstimator(TorchParams):
    """Train via a user ``train_fn(args, ctx)`` on a cluster; yields TorchModel.

    ``train_fn`` must export a bundle to ``args.export_dir`` (the reference's
    map_fun exported a SavedModel the same way).

    ``epochs`` semantics by input mode (same split as the reference): in
    STREAMING mode the *driver* replays the dataset ``epochs`` times
    through the feed, in ``train_mode`` (``"sync"`` publishes the sync
    manifest block, with ``embedding_plan`` in it, for collective
    train_fns).  In DIRECT mode ``fit`` drives the ledger-backed ingest
    feed whenever it has a shard spec — a path / glob / list-of-paths
    dataset, or rows staged via ``tfrecord_dir`` — so
    ``cluster.train(spec, num_epochs=epochs)`` replays the shard set
    through the partition ledger and the train_fn inherits at-least-once
    re-feed, sub-shard parallelism, and elastic recovery by consuming
    ``ctx.get_data_feed()`` (the reference's estimator stayed
    self-service here).  Self-service train_fns that read files
    themselves instead of consuming the feed keep working: the path feed
    is tiny and is drained at shutdown.
    """

    def __init__(self, train_fn: Callable, tf_args: Any = None,
                 launcher: Any = None, env: dict | None = None,
                 per_node_env: list | None = None, **params: Any):
        super().__init__(**params)
        self.train_fn = train_fn
        self.tf_args = tf_args
        # Live placement objects ride on the estimator, not the Params bag
        # (a launcher is not a serializable config value): ``launcher`` as
        # cluster.run takes it, ``env``/``per_node_env`` the same env
        # layering cluster.run takes (reference: Spark placed executors for
        # ``pipeline.py:~400-500``; here placement is explicit).
        self.launcher = launcher
        self.env = env
        self.per_node_env = per_node_env
        # post-run node metadata view (filled by fit, success OR failure)
        self.last_cluster_info: list | None = None

    def fit(self, dataset: Any) -> "TorchModel":
        args = self.merge_args_params(self.tf_args)
        if args.get("export_dir") is None:
            raise ValueError("TorchEstimator requires export_dir (the model artifact path)")
        input_mode = args.input_mode
        shard_spec = _as_shard_spec(dataset) if input_mode == InputMode.DIRECT \
            else None
        # DIRECT + a shard spec (path/glob/dir or list of paths): nothing
        # to partition driver-side — the spec goes straight to the
        # ledger-driven ingest feed below.  A path that does NOT resolve
        # to TFRecord shards (e.g. a raw-image directory a self-service
        # train_fn reads its own way) is left alone: the previous
        # releases' self-service contract must keep working.
        if shard_spec is not None:
            from tensorflowonspark_torch.ingest import enumerate_shards

            try:
                enumerate_shards(shard_spec)
            except FileNotFoundError as e:
                logger.warning(
                    "DIRECT fit: %s — leaving the train_fn self-service "
                    "(no ledger-driven ingest feed for this dataset)", e)
                shard_spec = None
        data = None if shard_spec is not None else as_partitioned(
            dataset, default_partitions=max(1, args.num_executors))
        if args.get("tfrecord_dir"):
            # Stage to TFRecords so DIRECT-mode train_fns can read files
            # (reference: dfutil.saveAsTFRecords before TFCluster.run).
            rows = data if data is not None and _is_row_data(data) else None
            if rows is None:
                raise ValueError("tfrecord_dir staging requires row-dict datasets")
            dfutil.save_as_tfrecords(rows, args.tfrecord_dir)
            args.merge({"data_dir": args.tfrecord_dir})
            if input_mode == InputMode.DIRECT:
                shard_spec = args.tfrecord_dir  # feed the staged shards
        cluster = _cluster.run(
            self.train_fn,
            args,
            num_executors=args.num_executors,
            input_mode=input_mode,
            master_node=args.master_node,
            tensorboard=args.tensorboard,
            log_dir=args.log_dir,
            feed_timeout=args.feed_timeout,
            reservation_timeout=args.reservation_timeout,
            launcher=self.launcher,
            env=self.env,
            per_node_env=self.per_node_env,
            torch_distributed=bool(args.get("torch_distributed")),
        )
        try:
            if input_mode == InputMode.STREAMING:
                cluster.train(data, num_epochs=args.epochs,
                              shuffle_seed=args.shuffle_seed,
                              mode=args.get("train_mode", "async"),
                              embedding=args.get("embedding_plan"))
            elif shard_spec is not None:
                # DIRECT onto the ledger-driven ingest feed: shard (and
                # sub-shard span) work items flow through the partition
                # ledger, so the pipeline layer inherits at-least-once
                # re-feed and elastic recovery instead of staying
                # self-service
                cluster.train(shard_spec, num_epochs=args.epochs,
                              shuffle_seed=args.shuffle_seed,
                              mode=args.get("train_mode", "async"),
                              embedding=args.get("embedding_plan"))
        finally:
            try:
                cluster.shutdown()
            finally:
                # post-run node metadata (update_meta patches: device facts,
                # step counts, TB url) — the observability view the
                # reference exposed through TFCluster; captured even when
                # shutdown re-raises a node error, so failed runs can be
                # diagnosed from it
                self.last_cluster_info = cluster.coordinator.cluster_info()
        # the fitted model inherits the placement surface: transform() must
        # score on the hosts that trained, not default-local
        model = TorchModel(tf_args=args, launcher=self.launcher, env=self.env,
                         per_node_env=self.per_node_env)
        model.set("export_dir", args.export_dir)
        for name in ("batch_size", "input_mapping", "output_mapping"):
            if self.is_set(name):
                model.set(name, self.get(name))
        return model


# -- model (reference TFModel, pipeline.py:~500-700) --------------------------

class TorchModel(TorchParams):
    """Batch inference over a partitioned dataset from an exported bundle."""

    def __init__(self, tf_args: Any = None, launcher: Any = None,
                 env: dict | None = None, per_node_env: list | None = None,
                 **params: Any):
        super().__init__(**params)
        self.tf_args = tf_args
        # Same placement surface as TorchEstimator (each call to transform
        # launches a fresh scoring cluster through these).
        self.launcher = launcher
        self.env = env
        self.per_node_env = per_node_env

    def transform(self, dataset: Any) -> PartitionedDataset:
        """Score rows on a cluster of executors; preserves partition order/count.

        Reference parity (``pipeline.py:~500-700``): ``TFModel._transform``
        scored partitions on *executors* with a per-executor cached
        SavedModel.  Here each of ``num_executors`` node processes runs
        ``inference.bundle_inference_loop`` over its share of partitions with
        a per-process cached bundle; the driver merges predictions back into
        the rows.  Rows are dicts; ``input_mapping`` {column → model input}
        selects feature columns (multi-column mappings are concatenated on
        the feature axis, see ``inference.rows_to_features``);
        ``output_mapping`` {model output → column} names prediction columns
        (default: {"prediction": "prediction"}).  The scoring nodes take
        their device from the model's args (``device``, default ``cuda``).

        ``scoring="sharded"`` scores over one mesh of the data nodes
        (``inference.sharded_bundle_inference_loop``, with
        ``torch_distributed`` set): the model sharded over it, each node
        emitting its own rows, every node given at least one partition and
        end-of-feed as soon as its share is done.
        """
        from tensorflowonspark_torch.inference import (
            bundle_inference_loop,
            sharded_bundle_inference_loop,
        )

        args = self.merge_args_params(self.tf_args)
        export_dir = args.get("export_dir")
        if not export_dir:
            raise ValueError("TorchModel requires export_dir")
        num_executors = max(1, int(args.get("num_executors") or 1))
        data = as_partitioned(dataset, default_partitions=num_executors)
        output_mapping = args.get("output_mapping") or {"prediction": "prediction"}
        scoring = args.get("scoring") or "task"
        if scoring not in ("task", "sharded"):
            raise ValueError(f"unknown scoring mode {scoring!r}; "
                             "use 'task' or 'sharded'")
        sharded = scoring == "sharded"
        if sharded and data.num_partitions < num_executors:
            raise ValueError(
                f"scoring='sharded' needs at least one partition per node "
                f"({data.num_partitions} partitions < {num_executors} nodes)")
        # One-pass input read: capture rows WHILE they stream to the scoring
        # nodes, so partitions are consumed exactly once (no double IO on
        # file-backed datasets; consume-once generator partitions work).
        captured: dict[int, list] = {}

        def _tee(p: int):
            def gen():
                rows = captured[p] = []
                for row in data.iter_partition(p):
                    rows.append(row)
                    yield row

            return gen

        tee_data = PartitionedDataset([_tee(p) for p in range(data.num_partitions)])
        cluster = _cluster.run(
            sharded_bundle_inference_loop if sharded else bundle_inference_loop,
            args,
            num_executors=num_executors,
            input_mode=InputMode.STREAMING,
            feed_timeout=args.feed_timeout,
            reservation_timeout=args.reservation_timeout,
            launcher=self.launcher,
            env=self.env,
            per_node_env=self.per_node_env,
            torch_distributed=bool(args.get("torch_distributed")),
        )
        try:
            # sharded scoring needs eager EOF: a node whose share ran out
            # keeps joining the mesh's rounds until its peers finish
            pred_parts = cluster.inference(tee_data, flat=False,
                                           eof_when_done=sharded)
        finally:
            try:
                cluster.shutdown()
            finally:
                # the nodes' final telemetry (rows, kernel launches): the
                # scoring cluster's counterpart of the estimator's
                # last_cluster_info
                self.last_cluster_metrics = cluster.metrics()
        parts = []
        for p, preds in enumerate(pred_parts):
            rows = captured.get(p)
            if rows is None:
                raise RuntimeError(f"partition {p} produced predictions but was "
                                   "never streamed (tee invariant violated)")
            if len(preds) != len(rows):
                raise RuntimeError(
                    f"partition {p}: {len(preds)} predictions for {len(rows)} rows "
                    "(exactly-count invariant violated)")
            parts.append(merge_prediction_rows(rows, preds, output_mapping))
        return PartitionedDataset.from_partitions(parts)


def merge_prediction_rows(rows: list, preds: list, output_mapping: dict) -> list:
    """Merge per-row predictions into result rows under ``output_mapping``
    ({model output → result column}).

    Single-output models emit one array per row and the mapping's single
    column receives it.  Multi-output models emit a dict per row
    (``bundle_inference_loop`` slices dict apply outputs row-wise); each
    mapped output lands in its column, and BOTH mismatch directions error
    loudly — an output the mapping does not name would otherwise be dropped
    silently, and a mapped name the model never produced used to get the
    whole prediction blob copied under every column (multi-output mappings
    silently mapped wrong before this check existed).
    """
    out = []
    expected = set(output_mapping)
    for row, pred in zip(rows, preds):
        row_out = dict(row) if isinstance(row, dict) else {}
        if isinstance(pred, dict):
            if set(pred) != expected:
                # per ROW, not once: a conditional head that drops an output
                # for some rows must fail with the mapping named, never a
                # bare KeyError (or a silently ignored extra output)
                unmapped = sorted(set(pred) - expected)
                if unmapped:
                    raise ValueError(
                        f"model outputs {unmapped} are not in output_mapping "
                        f"{sorted(output_mapping)}; map every output (or drop "
                        "it explicitly model-side)")
                raise ValueError(
                    f"output_mapping names {sorted(expected - set(pred))} but "
                    f"this row's prediction only has {sorted(pred)}")
            for name, col in output_mapping.items():
                row_out[col] = np.asarray(pred[name])
        else:
            if len(output_mapping) > 1:
                raise ValueError(
                    f"output_mapping has {len(output_mapping)} entries "
                    f"({sorted(output_mapping)}) but the model emits a single "
                    "unnamed output; multi-output mapping needs dict "
                    "predictions (a dict-returning apply fn)")
            for _, col in output_mapping.items():
                row_out[col] = np.asarray(pred)
        out.append(row_out)
    return out


def _as_shard_spec(dataset: Any):
    """A DIRECT-mode fit dataset that is already a shard spec (path, glob,
    directory, or list of paths) — returned as-is for the ledger feed;
    None means row data (needs ``tfrecord_dir`` staging)."""
    if isinstance(dataset, (str, os.PathLike)):
        return dataset
    if isinstance(dataset, (list, tuple)) and dataset and all(
            isinstance(p, (str, os.PathLike)) for p in dataset):
        return list(dataset)
    return None


def _is_row_data(data: PartitionedDataset) -> bool:
    for p in range(data.num_partitions):
        for row in data.iter_partition(p):
            return isinstance(row, dict)
    return False


