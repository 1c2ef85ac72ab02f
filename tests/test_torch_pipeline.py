"""The port's ML pipeline layer (``tensorflowonspark_torch/pipeline.py``,
``TorchEstimator`` / ``TorchModel``) on the CPU: the restated units of
``tests/test_pipeline.py`` (Params and accessors, ``Namespace``,
``merge_prediction_rows``, ``rows_to_features``, the export-dir,
scoring-mode and env-knob checks), BASELINE config 4's end-to-end gate
(``fit`` → ``transform`` through real node processes at vocab 1009,
ordered and exactly counted, the transform's scores held against the JAX
``build_apply`` of the same bundle at rtol 1e-5 / atol 1e-6), the ``steps``
cap, DIRECT staging, DIRECT fit onto the ledger-driven ingest feed, and the
sharded scorer: ``scoring="sharded"`` over a 2-node gloo mesh, its
streaming form (5 partitions over 2 nodes, ``window=1``) and
``_local_rows``, held against the JAX ``build_apply`` at rtol 1e-4 /
atol 1e-5 (the JAX tests').
"""

import os

import numpy as np
import pytest
import torch

from tensorflowonspark_torch import pipeline
from tensorflowonspark_torch.cluster import InputMode
from tensorflowonspark_torch.data import PartitionedDataset
from tensorflowonspark_torch.models import wide_deep
from torch_lock_gate import torch_lock_witness_gate  # noqa: F401 - the port's lock-witness gate

from tests import torch_mapfuns


class TestParams:
    def test_accessor_synthesis(self):
        p = pipeline.TorchParams()
        p.setBatchSize(128).setEpochs(3)
        assert p.getBatchSize() == 128
        assert p.get("epochs") == 3

    def test_unknown_param_rejected(self):
        with pytest.raises(KeyError):
            pipeline.TorchParams().set("nope", 1)
        with pytest.raises(AttributeError):
            pipeline.TorchParams().setNope(1)

    def test_defaults_and_explain(self):
        p = pipeline.TorchParams()
        assert p.get("batch_size") == 64
        assert not p.is_set("batch_size")
        assert "batch_size" in p.explain_params()

    def test_copy_isolated(self):
        a = pipeline.TorchParams().setBatchSize(8)
        b = a.copy().setBatchSize(16)
        assert a.getBatchSize() == 8
        assert b.getBatchSize() == 16

    def test_params_match_the_jax_package_but_the_distributed_switch(self):
        """Every Param the JAX package declares, with its default, except
        ``jax_distributed``, which is ``torch_distributed`` here."""
        from tensorflowonspark_tpu import pipeline as jpipeline

        def default(p):  # the two packages' InputMode enums compare by name
            return getattr(p.default, "name", p.default)

        jax_params = {n: default(p) for n, p in jpipeline.TPUParams.params().items()}
        port = {n: default(p) for n, p in pipeline.TorchParams.params().items()}
        jax_params["torch_distributed"] = jax_params.pop("jax_distributed")
        assert port == jax_params


class TestNamespace:
    def test_merge_precedence(self):
        ns = pipeline.Namespace({"a": 1, "b": 2}, {"b": 3})
        assert ns.a == 1 and ns.b == 3
        assert "a" in ns and "zz" not in ns

    def test_argparse_source(self):
        import argparse

        src = argparse.Namespace(x=5)
        assert pipeline.Namespace(src).x == 5

    def test_params_merge_over_args(self):
        est = pipeline.TorchParams().setBatchSize(32)
        ns = est.merge_args_params({"batch_size": 8, "extra": "kept"})
        assert ns.batch_size == 32      # set param wins
        assert ns.extra == "kept"
        ns2 = pipeline.TorchParams().merge_args_params({"batch_size": 8})
        assert ns2.batch_size == 8      # unset param defers to args


class TestFitTransform:
    def test_fit_then_transform(self, tmp_path):
        """BASELINE config 4's end-to-end gate: fit streams 32 rows into two
        node processes, the chief exports; transform scores 20 rows in two
        partitions — exactly counted, in input order, each prediction the
        JAX package's score of the same row from the same bundle."""
        from tensorflowonspark_torch.checkpoint import load_bundle
        from tensorflowonspark_torch.inference import rows_to_features
        from tensorflowonspark_tpu.models import registry as jreg

        rows = wide_deep.synthetic_criteo(32, seed=1)
        data = PartitionedDataset.from_iterable(rows, 4)
        est = pipeline.TorchEstimator(
            torch_mapfuns.train_wide_deep, {"vocab_size": 1009, "device": "cpu"})
        est.setNumExecutors(2).setEpochs(1).setBatchSize(16)
        est.set("export_dir", str(tmp_path / "export"))
        est.set("log_dir", str(tmp_path / "logs"))
        model = est.fit(data)
        assert os.path.isdir(tmp_path / "export")
        losses = [f for f in os.listdir(tmp_path / "logs") if f.startswith("loss_")]
        assert len(losses) == 2

        scored = model.transform(PartitionedDataset.from_iterable(rows[:20], 2))
        out = list(scored)
        assert len(out) == 20                      # exactly-count
        assert scored.num_partitions == 2          # partition structure kept
        assert all("prediction" in r for r in out)
        assert all(np.allclose(r["features"], rows[i]["features"])
                   for i, r in enumerate(out))
        params, config = load_bundle(str(tmp_path / "export"))
        want = np.asarray(jreg.build_apply(config)(params, rows_to_features(rows[:20], None)))
        np.testing.assert_allclose([float(r["prediction"]) for r in out], want,
                                   rtol=1e-5, atol=1e-6)

    def test_fit_steps_param_caps_training(self, tmp_path):
        """setSteps(N) stops each node after N train steps with data left
        over (reference args.steps semantics)."""
        rows = wide_deep.synthetic_criteo(64, seed=2)
        est = pipeline.TorchEstimator(torch_mapfuns.train_wide_deep,
                                      {"vocab_size": 1009, "device": "cpu"})
        est.setNumExecutors(2).setEpochs(1).setBatchSize(8).setSteps(2)
        est.set("export_dir", str(tmp_path / "export"))
        est.set("log_dir", str(tmp_path / "logs"))
        model = est.fit(PartitionedDataset.from_iterable(rows, 8))
        # 64 rows / 2 nodes / bs 8 = 4 possible steps; capped at 2
        assert [m["train_steps"] for m in est.last_cluster_info] == [2, 2]
        assert os.path.isdir(tmp_path / "export")
        losses = [f for f in os.listdir(tmp_path / "logs") if f.startswith("loss_")]
        assert len(losses) == 2
        scored = model.transform(PartitionedDataset.from_iterable(rows[:12], 2))
        out = list(scored)
        assert len(out) == 12 and scored.num_partitions == 2
        assert all("prediction" in r for r in out)
        assert all(np.allclose(r["features"], rows[i]["features"])
                   for i, r in enumerate(out))

    def test_transform_sharded_requires_enough_partitions(self):
        m = pipeline.TorchModel()
        m.set("export_dir", "/nonexistent")
        m.setNumExecutors(4).setScoring("sharded")
        with pytest.raises(ValueError, match="at least one partition"):
            m.transform(PartitionedDataset.from_iterable(list(range(8)), 2))

    def test_transform_sharded_scoring_is_not_ported(self, monkeypatch):
        """Named from before ``scoring="sharded"`` was ported, when it
        raised: it now runs ``sharded_bundle_inference_loop`` on the nodes
        and asks the cluster for end-of-feed as soon as a node's share is
        done (free dispatch, ``cluster.py``), as the JAX ``transform``
        does."""
        from tensorflowonspark_torch import inference

        seen = {}

        class Cluster:
            def inference(self, data, flat, eof_when_done):
                seen["eof_when_done"] = eof_when_done
                return [[np.zeros(1)] * len(list(data.iter_partition(p)))
                        for p in range(data.num_partitions)]

            def shutdown(self):
                seen["shutdown"] = True

            def metrics(self):
                return {"counters": {"rows": 8}}

        def run(map_fun, args, **kwargs):
            seen["map_fun"] = map_fun
            seen["torch_distributed"] = kwargs["torch_distributed"]
            return Cluster()

        monkeypatch.setattr(pipeline._cluster, "run", run)
        m = pipeline.TorchModel()
        m.set("export_dir", "/nonexistent").set("torch_distributed", True)
        m.setNumExecutors(2).setScoring("sharded")
        out = list(m.transform(PartitionedDataset.from_iterable(list(range(8)), 2)))
        assert len(out) == 8 and seen == {
            "map_fun": inference.sharded_bundle_inference_loop, "torch_distributed": True,
            "eof_when_done": True, "shutdown": True}
        assert m.last_cluster_metrics == {"counters": {"rows": 8}}

    def test_transform_sharded_scoring_two_process(self, tmp_path):
        """``setScoring("sharded")`` with ``torch_distributed``: the
        wide-and-deep bundle the JAX package exported, fsdp-sharded over a
        2-node gloo mesh, scores 16 rows in 4 partitions — every row once,
        in order, within rtol 1e-4 / atol 1e-5 of the JAX
        ``build_apply``."""
        rows, expected = _sharded_bundle(tmp_path, 16, seed=6)
        m = pipeline.TorchModel(tf_args={"device": "cpu"})
        m.set("export_dir", str(tmp_path / "b")).set("torch_distributed", True)
        m.setNumExecutors(2).setBatchSize(4).setScoring("sharded")
        m.set("reservation_timeout", 120.0)
        out = list(m.transform(PartitionedDataset.from_iterable(rows, 4)))
        assert len(out) == 16
        assert all(np.allclose(r["features"], rows[i]["features"]) for i, r in enumerate(out))
        np.testing.assert_allclose(np.stack([r["prediction"] for r in out]), expected,
                                   rtol=1e-4, atol=1e-5)

    def test_estimator_requires_export_dir(self):
        est = pipeline.TorchEstimator(torch_mapfuns.noop, {})
        with pytest.raises(ValueError, match="export_dir"):
            est.fit([1, 2, 3])

    def test_model_requires_export_dir(self):
        with pytest.raises(ValueError, match="export_dir"):
            pipeline.TorchModel().transform([{"features": np.zeros(39)}])

    def test_rows_to_features_multi_column(self):
        from tensorflowonspark_torch.inference import rows_to_features

        rows = [{"a": [1.0, 2.0], "b": 3.0}, {"a": [4.0, 5.0], "b": 6.0}]
        x = rows_to_features(rows, {"a": "in_a", "b": "in_b"})
        np.testing.assert_allclose(x, [[1, 2, 3], [4, 5, 6]])
        imgs = [{"image": np.zeros((4, 4, 3))} for _ in range(2)]
        assert rows_to_features(imgs, {"image": "x"}).shape == (2, 4, 4, 3)
        with pytest.raises(KeyError, match="zz"):
            rows_to_features(rows, {"zz": "x"})


def test_direct_fit_onto_the_ingest_feed_is_not_ported(tmp_path, monkeypatch):
    """Named from before the ingest tier was ported, when a DIRECT fit over
    a shard spec raised.  Now ``tests/test_pipeline.py::
    test_fit_direct_feeds_ledger_ingest`` restated: ``TorchEstimator.fit``
    in DIRECT mode drives the ledger-backed ingest feed — a shard-spec
    dataset goes through ``cluster.train``, nodes consume
    ``ctx.get_data_feed()``, and every record is delivered exactly once on
    the happy path — no self-service reads."""
    from tensorflowonspark_torch import tfrecord

    monkeypatch.setenv("TOS_SHM_RING", "0")
    shard_dir = tmp_path / "shards"
    os.makedirs(shard_dir)
    total = 0
    for s in range(4):
        recs = [f"s{s}-r{i}".encode() for i in range(25)]
        tfrecord.write_records(str(shard_dir / f"part-{s:05d}"), recs)
        total += len(recs)
    est = pipeline.TorchEstimator(torch_mapfuns.direct_fit_counter, {})
    est.setNumExecutors(2).setEpochs(1).setBatchSize(16)
    est.setInputMode(InputMode.DIRECT)
    est.set("export_dir", str(tmp_path / "export"))
    est.set("log_dir", str(tmp_path / "logs"))
    est.fit(str(shard_dir))
    counts = []
    for f in (tmp_path / "logs").glob("fit_count_*.txt"):
        counts.append(int(f.read_text()))
    assert sum(counts) == total          # the ledger fed every record
    assert len(counts) == 2 and all(c > 0 for c in counts)  # both nodes


def test_direct_fit_stages_rows_for_a_self_service_train_fn(tmp_path):
    """DIRECT + ``tfrecord_dir``: the estimator stages the rows as TFRecord
    shards and the train_fn reads them itself from ``args.data_dir``."""
    rows = [{"x": float(i), "label": i % 2} for i in range(40)]
    est = pipeline.TorchEstimator(torch_mapfuns.count_staged_rows, {})
    est.setNumExecutors(2).setInputMode(InputMode.DIRECT)
    est.set("export_dir", str(tmp_path / "export"))
    est.set("log_dir", str(tmp_path / "logs"))
    est.setTFRecordDir(str(tmp_path / "staged"))
    os.makedirs(tmp_path / "logs")
    est.fit(PartitionedDataset.from_iterable(rows, 4))
    counts = [int((tmp_path / "logs" / f"staged_{i}.txt").read_text()) for i in range(2)]
    assert sum(counts) == 40 and all(c > 0 for c in counts)


def test_direct_fit_stages_rows_for_a_self_service_train_fn_in_jax(tmp_path):
    """The scenario of ``test_direct_fit_stages_rows_for_a_self_service_train_fn``
    through the JAX package's ``TPUEstimator`` with a JAX-side train_fn
    (``count_staged_rows_jax``, the same self-service read): the JAX
    reference of that test, held to exactly its assertions, so that a
    failure of the port's can be told from a fault of the port.  The
    train_fn never reads the feed that ``fit`` drives over the staged
    shards, so both packages race its exit against the feeder's writes
    (``cluster.train``): run alone, each fails now and then with the
    feeder's broken pipe or reset connection (ROADMAP §3, "Not faults",
    gives the command that counts them)."""
    from tensorflowonspark_tpu import pipeline as jpipeline
    from tensorflowonspark_tpu.cluster import InputMode as JInputMode
    from tensorflowonspark_tpu.data import PartitionedDataset as JPartitionedDataset

    rows = [{"x": float(i), "label": i % 2} for i in range(40)]
    est = jpipeline.TPUEstimator(torch_mapfuns.count_staged_rows_jax, {})
    est.setNumExecutors(2).setInputMode(JInputMode.DIRECT)
    est.set("export_dir", str(tmp_path / "export"))
    est.set("log_dir", str(tmp_path / "logs"))
    est.setTFRecordDir(str(tmp_path / "staged"))
    os.makedirs(tmp_path / "logs")
    est.fit(JPartitionedDataset.from_iterable(rows, 4))
    counts = [int((tmp_path / "logs" / f"staged_{i}.txt").read_text()) for i in range(2)]
    assert sum(counts) == 40 and all(c > 0 for c in counts)


def _sharded_bundle(tmp_path, n_rows, seed):
    """The JAX package's wide-and-deep bundle at ``tmp_path/b`` and
    ``n_rows`` synthetic rows with the JAX ``build_apply``'s scores."""
    import jax

    from tensorflowonspark_torch.inference import rows_to_features
    from tensorflowonspark_tpu.checkpoint import export_bundle
    from tensorflowonspark_tpu.models import registry as jreg
    from tensorflowonspark_tpu.models import wide_deep as jwd

    config = {"model": "wide_deep", "vocab_size": 101, "embed_dim": 4,
              "hidden": (8,), "bf16": False}
    params = jax.device_get(jwd.init_params(jwd.build_wide_deep(config),
                                            jax.random.PRNGKey(0)))
    export_bundle(str(tmp_path / "b"), params, config)
    rows = wide_deep.synthetic_criteo(n_rows, seed=seed)
    return rows, np.asarray(jreg.build_apply(config)(params, rows_to_features(rows, None)))


@pytest.mark.parametrize("mesh_axes", [{"fsdp": -1}, {"tp": 2}], ids=["fsdp", "tp"])
def test_two_process_sharded_streaming_inference(tmp_path, mesh_axes):
    """The restated ``tests/test_distributed.py`` streaming case: params
    fsdp-sharded over a 2-node gloo mesh, 24 rows in 5 partitions (uneven,
    so the drier node joins rounds with filler batches), ``window=1``
    (free dispatch must win over the window, or the nodes would wait for
    each other in a collective), each node emitting only its own rows:
    exactly 24 results in order, equal to the JAX ``build_apply``'s.  On a
    ``tp=2`` mesh the two nodes are peers on the same rows: each scores
    both nodes' batches and emits its own (``_peer_batch``,
    ``_local_rows``), so no row is lost or doubled."""
    from tensorflowonspark_torch import cluster as tcluster
    from tensorflowonspark_torch.inference import sharded_bundle_inference_loop

    rows, expected = _sharded_bundle(tmp_path, 24, seed=5)
    cluster = tcluster.run(
        sharded_bundle_inference_loop,
        {"export_dir": str(tmp_path / "b"), "batch_size": 4, "mesh_axes": mesh_axes,
         "device": "cpu"},
        num_executors=2, input_mode=InputMode.STREAMING, torch_distributed=True,
        log_dir=str(tmp_path / "logs"), reservation_timeout=120.0)
    try:
        parts = dict(cluster.inference_stream(PartitionedDataset.from_iterable(rows, 5),
                                              window=1, eof_when_done=True))
    finally:
        cluster.shutdown(timeout=120.0)
    results = [x for p in sorted(parts) for x in parts[p]]
    assert len(results) == 24
    np.testing.assert_allclose(np.stack(results), expected, rtol=1e-4, atol=1e-5)


def test_local_rows_dedupes_replicated_mesh_axes():
    """``inference._local_rows`` must not duplicate rows when a non-batch
    axis (tp) puts several ranks on the same rows: on a dp4 × tp2 mesh each
    rank scores its tp pair's two batches and keeps its own block, so the
    8 ranks emit the 8 rows, each once (the restated
    ``tests/test_pipeline.py`` case, whose mesh holds the same layout)."""
    from torch.distributed.device_mesh import DeviceMesh

    from tensorflowonspark_torch.inference import _local_rows
    from tensorflowonspark_torch.parallel import mesh as tmesh

    x = torch.arange(8.0)[:, None] * torch.ones((1, 3))
    emitted = []
    for r in range(8):
        mesh = DeviceMesh("cpu", torch.arange(8).reshape(4, 1, 2, 1, 1, 1),
                          mesh_dim_names=tmesh.AXES, _init_backend=False, _rank=r)
        dp, tp = tmesh.axis_index(mesh, "dp"), tmesh.axis_index(mesh, "tp")
        assert (dp, tp) == (r // 2, r % 2)
        pair = x[2 * dp:2 * dp + 2]  # the two tp peers' one-row batches, peer order
        mine = _local_rows(pair, mesh)
        np.testing.assert_array_equal(mine.numpy(), x[r:r + 1].numpy())
        emitted.append(mine)
    np.testing.assert_array_equal(torch.cat(emitted).numpy(), x.numpy())
    assert _local_rows({"a": pair}, mesh)["a"].shape == (1, 3)


def test_transform_rejects_unknown_scoring_mode():
    m = pipeline.TorchModel()
    m.set("export_dir", "/nonexistent").set("scoring", "SHARDED")
    with pytest.raises(ValueError, match="unknown scoring mode"):
        m.transform(PartitionedDataset.from_iterable(list(range(4)), 2))


def test_env_timeout_knobs_reach_pipeline(monkeypatch):
    """TOS_* env defaults apply through TorchEstimator/TorchModel too (the
    Params default to None and defer to cluster.run's env lookup)."""
    monkeypatch.setenv("TOS_FEED_TIMEOUT", "77")
    ns = pipeline.TorchParams().merge_args_params({})
    assert ns.feed_timeout is None
    from tensorflowonspark_torch.cluster import _env_float

    assert _env_float("TOS_FEED_TIMEOUT", 600.0) == 77.0


class TestAccessorSynthesis:
    def test_acronym_accessors_resolve(self):
        p = pipeline.TorchParams()
        p.setTFRecordDir("/tmp/tfr")
        assert p.getTFRecordDir() == "/tmp/tfr"
        assert p.get("tfrecord_dir") == "/tmp/tfr"
        p.setTorchDistributed(True)
        assert p.getTorchDistributed() is True

    def test_every_declared_param_round_trips_through_accessors(self):
        p = pipeline.TorchParams()
        for i, name in enumerate(sorted(p.params())):
            camel = "".join(part.capitalize() for part in name.split("_"))
            sentinel = f"v{i}"
            getattr(p, f"set{camel}")(sentinel)
            assert getattr(p, f"get{camel}")() == sentinel, name
            assert p.get(name) == sentinel, name

    def test_unknown_accessors_still_raise(self):
        with pytest.raises(AttributeError):
            pipeline.TorchParams().setNotAParam(1)
        with pytest.raises(AttributeError):
            pipeline.TorchParams().getNotAParam()


class TestMergePredictionRows:
    """Multi-output ``output_mapping``: named outputs route to their own
    columns and mismatches error loudly."""

    def _two_output_preds(self, n=4):
        # a genuine two-output torch apply, sliced per row as
        # bundle_inference_loop emits dict outputs
        from tensorflowonspark_torch.inference import batch_results, to_host

        w_cls = torch.arange(6, dtype=torch.float32).reshape(3, 2)
        w_emb = torch.ones(3, 5)
        x = np.random.RandomState(0).randn(n, 3).astype(np.float32)
        t = torch.from_numpy(x)
        out = to_host({"logits": t @ w_cls, "embedding": torch.tanh(t @ w_emb)})
        return x, out, batch_results(out, n, None)

    def test_two_output_model_maps_each_head(self):
        x, out, preds = self._two_output_preds()
        rows = [{"features": x[i]} for i in range(len(x))]
        merged = pipeline.merge_prediction_rows(
            rows, preds, {"logits": "score", "embedding": "emb"})
        for i, r in enumerate(merged):
            np.testing.assert_array_equal(r["score"], out["logits"][i])
            np.testing.assert_array_equal(r["emb"], out["embedding"][i])
            assert "features" in r

    def test_unmapped_model_output_errors(self):
        _, _, preds = self._two_output_preds()
        with pytest.raises(ValueError, match="not in output_mapping"):
            pipeline.merge_prediction_rows(
                [{}] * len(preds), preds, {"logits": "score"})

    def test_mapping_names_missing_output_errors(self):
        _, _, preds = self._two_output_preds()
        with pytest.raises(ValueError, match="only has"):
            pipeline.merge_prediction_rows(
                [{}] * len(preds), preds,
                {"logits": "score", "embedding": "emb", "aux": "a"})

    def test_key_mismatch_on_a_later_row_still_errors_loudly(self):
        preds = [{"a": np.zeros(2), "b": np.zeros(2)},
                 {"a": np.zeros(2)}]
        with pytest.raises(ValueError, match="only has"):
            pipeline.merge_prediction_rows(
                [{}, {}], preds, {"a": "col_a", "b": "col_b"})
        preds2 = [{"a": np.zeros(2)}, {"a": np.zeros(2), "x": np.zeros(2)}]
        with pytest.raises(ValueError, match="not in output_mapping"):
            pipeline.merge_prediction_rows([{}, {}], preds2, {"a": "col_a"})

    def test_multi_entry_mapping_needs_named_outputs(self):
        preds = [np.zeros(2), np.zeros(2)]
        with pytest.raises(ValueError, match="single unnamed output"):
            pipeline.merge_prediction_rows(
                [{}, {}], preds, {"a": "col_a", "b": "col_b"})

    def test_single_output_back_compat(self):
        preds = [np.full(2, 7.0), np.full(2, 9.0)]
        merged = pipeline.merge_prediction_rows(
            [{"k": 1}, {"k": 2}], preds, {"prediction": "prediction"})
        np.testing.assert_array_equal(merged[0]["prediction"], preds[0])
        assert merged[1]["k"] == 2

    def test_bundle_loop_emits_dict_rows_for_dict_apply(self):
        """The loop's per-row slicing of dict outputs (``batch_results``)
        gives the transform merge named per-row predictions."""
        from tensorflowonspark_torch.inference import batch_results

        out = {"a": np.arange(6).reshape(3, 2), "b": np.arange(3)}
        results = batch_results(out, 2, None)
        assert len(results) == 2
        np.testing.assert_array_equal(results[1]["a"], [2, 3])
        assert results[1]["b"] == 1

    def test_argmax_emits_class_ids_and_sequence_ids(self):
        """``postprocess="argmax"``: an int per row for class scores, and
        each row's ``[S]`` ids for a sequence model's ``[B, S, V]`` logits
        (the LM bundle scored by ``transform``); the padding rows dropped."""
        from tensorflowonspark_torch.inference import batch_results

        scores = np.random.RandomState(0).randn(4, 5)
        assert batch_results(scores, 3, "argmax") == [int(i) for i in scores[:3].argmax(-1)]
        logits = np.random.RandomState(1).randn(4, 6, 5)
        ids = batch_results(logits, 2, "argmax")
        assert len(ids) == 2
        for row, want in zip(ids, logits[:2].argmax(-1)):
            np.testing.assert_array_equal(row, want)
