"""The port's ML pipeline layer (``tensorflowonspark_torch/pipeline.py``,
``TorchEstimator`` / ``TorchModel``) on the CPU: the restated units of
``tests/test_pipeline.py`` (Params and accessors, ``Namespace``,
``merge_prediction_rows``, ``rows_to_features``, the export-dir,
scoring-mode and env-knob checks), BASELINE config 4's end-to-end gate
(``fit`` → ``transform`` through real node processes at vocab 1009,
ordered and exactly counted, the transform's scores held against the JAX
``build_apply`` of the same bundle at rtol 1e-5 / atol 1e-6), the ``steps``
cap, DIRECT staging, and the two paths that raise until their items land.
"""

import os

import numpy as np
import pytest
import torch

from tensorflowonspark_torch import pipeline
from tensorflowonspark_torch.cluster import InputMode
from tensorflowonspark_torch.data import PartitionedDataset
from tensorflowonspark_torch.models import wide_deep

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

    def test_transform_sharded_scoring_is_not_ported(self):
        m = pipeline.TorchModel()
        m.set("export_dir", "/nonexistent")
        m.setNumExecutors(2).setScoring("sharded")
        with pytest.raises(NotImplementedError, match=r"queue 1 \(l\)"):
            m.transform(PartitionedDataset.from_iterable(list(range(8)), 2))

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


def test_direct_fit_onto_the_ingest_feed_is_not_ported(tmp_path):
    """A DIRECT fit over a shard spec that resolves to shard files is what
    the JAX package feeds through its ledger-driven ingest feed: the port
    raises naming queue 1 (i), before it starts a cluster."""
    from tensorflowonspark_torch import tfrecord

    shard_dir = tmp_path / "shards"
    os.makedirs(shard_dir)
    tfrecord.write_records(str(shard_dir / "part-00000"), [b"r0", b"r1"])
    est = pipeline.TorchEstimator(torch_mapfuns.noop, {})
    est.setInputMode(InputMode.DIRECT)
    est.set("export_dir", str(tmp_path / "export"))
    with pytest.raises(NotImplementedError, match=r"queue 1 \(i\)"):
        est.fit(str(shard_dir))
    with pytest.raises(NotImplementedError, match=r"queue 1 \(i\)"):
        est.fit([str(shard_dir / "part-00000")])


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
