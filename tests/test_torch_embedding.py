"""The port's sharded embedding tier (``tensorflowonspark_torch/embedding``,
the embedding-shard half of ``checkpoint.py``) on the CPU: the restated
units of ``tests/test_embedding.py`` (plan, init, CSR payloads, shard
checkpoints, the world-1 table; the numpy init and ids held bit for bit
against the JAX package's), and real node processes: the sparse-collective
probe, the 2-node sharded wide-and-deep run against the port's own
single-process unsharded reference BIT FOR BIT (digests of the dense half
and of the table), a SIGKILL of a shard owner, and the estimator-driven
sharded train served through the gateway's lookup fan-out.

The port's reference is in turn held against the JAX package's replay of
the same schedule from the same initial weights: losses at rtol 1e-5, the
dense half and the table at rtol 1e-5 / atol 1e-7 (float32 rounding in
other orders, four steps of SGD at lr 0.125 on values of order 0.1).
Served predictions are held against the JAX dense apply over the
reassembled table at rtol 1e-5 / atol 1e-6.
"""

from __future__ import annotations

import copy
import json
import os
import time

import numpy as np
import pytest
import torch

from tensorflowonspark_torch import cluster as tcluster
from tensorflowonspark_torch.checkpoint import (
    embedding_steps,
    latest_embedding_step,
    restore_embedding_shard,
    save_embedding_shard,
)
from tensorflowonspark_torch.collective import ops as cops
from tensorflowonspark_torch.collective import pack_csr, unpack_csr
from tensorflowonspark_torch.collective.transport import payload_nbytes
from tensorflowonspark_torch.embedding import (
    EmbeddingShard,
    ShardedTable,
    ShardPlan,
    init_rows,
)
from tensorflowonspark_torch.launcher import SubprocessLauncher
from tensorflowonspark_torch.models import wide_deep
from torch_lock_gate import torch_lock_witness_gate  # noqa: F401 - the port's lock-witness gate

from tests import torch_mapfuns


# -- plan / init units --------------------------------------------------------


def test_plan_bounds_ownership_partition():
    plan = ShardPlan.even("t", 10, 3, 3)
    assert plan.bounds == (0, 3, 6, 10)
    assert plan.world == 3
    assert plan.range_of(2) == (6, 10)
    assert plan.rows_of(2) == 4
    ids = np.array([0, 2, 3, 5, 6, 9], np.int64)
    assert plan.owner_of(ids).tolist() == [0, 0, 1, 1, 2, 2]
    idx = plan.partition(ids)
    assert sorted(np.concatenate(idx).tolist()) == list(range(ids.size))
    assert ids[idx[1]].tolist() == [3, 5]
    with pytest.raises(ValueError, match="outside"):
        plan.owner_of(np.array([10], np.int64))


def test_plan_manifest_roundtrip_and_reshard():
    plan = ShardPlan.even("wide_deep", 101, 5, 2)
    block = plan.to_manifest()
    assert ShardPlan.from_manifest(block) == plan
    r3 = plan.reshard(3)
    assert r3.total_rows == 101 and r3.dim == 5 and r3.world == 3
    assert r3.bounds[0] == 0 and r3.bounds[-1] == 101


def test_init_rows_slices_are_block_deterministic_and_match_jax():
    from tensorflowonspark_tpu.embedding import init_rows as jinit_rows

    total, dim = 5000, 3
    full = init_rows(total, dim, 0, total, seed=7)
    np.testing.assert_array_equal(init_rows(total, dim, 4000, 4500, seed=7),
                                  full[4000:4500])
    assert not np.array_equal(init_rows(total, dim, 0, 8, seed=8), full[:8])
    # the port's copy draws the JAX package's table, bit for bit
    np.testing.assert_array_equal(full, jinit_rows(total, dim, 0, total, seed=7))


def test_shard_create_zero_cols_and_range_checks():
    plan = ShardPlan.even("t", 12, 4, 2)
    shard = EmbeddingShard.create(plan, 1, seed=3, zero_cols=(3,))
    assert (shard.lo, shard.hi) == (6, 12)
    assert shard.rows.shape == (6, 4)
    np.testing.assert_array_equal(shard.rows[:, 3], np.zeros(6, np.float32))
    np.testing.assert_array_equal(shard.rows[:, :3],
                                  init_rows(12, 4, 6, 12, seed=3)[:, :3])
    with pytest.raises(ValueError, match="outside"):
        shard.lookup(np.array([2], np.int64))  # rank 0's rows


# -- CSR wire payloads --------------------------------------------------------


def test_pack_unpack_csr_roundtrip_and_metering():
    ids = np.array([3, 1, 7], np.int64)
    vals = np.arange(6, dtype=np.float32).reshape(3, 2)
    payload = pack_csr(ids, vals)
    got_ids, got_vals = unpack_csr(payload)
    np.testing.assert_array_equal(got_ids, ids)
    np.testing.assert_array_equal(got_vals, vals)
    assert payload_nbytes(payload) == ids.nbytes + vals.nbytes
    req = pack_csr(ids, None)
    assert unpack_csr(req)[1] is None
    assert payload_nbytes(req) == ids.nbytes
    with pytest.raises(ValueError, match="mismatch"):
        pack_csr(ids, vals[:2])


def test_combine_csr_exact_sum_and_order():
    dim = 2
    u, acc = cops.combine_csr(
        [np.array([5, 1, 5], np.int64), np.array([1, 9], np.int64)],
        [np.array([[1, 2], [3, 4], [10, 20]], np.float32),
         np.array([[100, 200], [7, 8]], np.float32)],
        dim)
    assert u.tolist() == [1, 5, 9]
    np.testing.assert_array_equal(
        acc, np.array([[103, 204], [11, 22], [7, 8]], np.float32))
    u0, a0 = cops.combine_csr([np.empty(0, np.int64)], [None], dim)
    assert u0.size == 0 and a0.shape == (0, dim)


# -- shard checkpoints: save / reassemble / gaps ------------------------------


def test_shard_checkpoint_reassembles_any_range(tmp_path):
    total, dim = 12, 3
    full = init_rows(total, dim, 0, total, seed=1)
    save_embedding_shard(str(tmp_path), "t", 4, 0, 5, full[0:5])
    save_embedding_shard(str(tmp_path), "t", 4, 5, 12, full[5:12])
    np.testing.assert_array_equal(
        restore_embedding_shard(str(tmp_path), "t", 4, 3, 9, dim), full[3:9])
    np.testing.assert_array_equal(
        restore_embedding_shard(str(tmp_path), "t", 4, 0, 12, dim), full)
    assert latest_embedding_step(str(tmp_path), "t") == 4
    assert embedding_steps(str(tmp_path), "t") == [4]
    assert latest_embedding_step(str(tmp_path), "other") is None
    os.remove(os.path.join(str(tmp_path), "embed_t", "step_4",
                           "shard_5_12.npz"))
    with pytest.raises(FileNotFoundError):
        restore_embedding_shard(str(tmp_path), "t", 4, 3, 9, dim)


def test_shard_files_read_across_packages(tmp_path):
    """The shard-checkpoint layout is shared: the JAX package reassembles
    what the port saved, and the other way round."""
    from tensorflowonspark_tpu import checkpoint as jckpt

    full = init_rows(10, 2, 0, 10, seed=2)
    save_embedding_shard(str(tmp_path), "x", 1, 0, 6, full[:6])
    jckpt.save_embedding_shard(str(tmp_path), "x", 1, 6, 10, full[6:])
    np.testing.assert_array_equal(
        jckpt.restore_embedding_shard(str(tmp_path), "x", 1, 0, 10, 2), full)
    np.testing.assert_array_equal(
        restore_embedding_shard(str(tmp_path), "x", 1, 2, 9, 2), full[2:9])


# -- world-1 table: the reference path ----------------------------------------


def test_world1_table_lookup_update_math(monkeypatch):
    plan = ShardPlan.even("t", 8, 2, 1)
    shard = EmbeddingShard(plan, 0, np.ones((8, 2), np.float32))
    table = ShardedTable(shard, None)
    ids = np.array([[3, 3], [5, 3]], np.int64)
    out = table.lookup(ids)
    assert out.shape == (2, 2, 2)
    np.testing.assert_array_equal(out, np.ones((2, 2, 2), np.float32))
    grads = np.ones((2, 2, 2), np.float32)
    n = table.apply_gradients(ids, grads, lr=0.5, scale=0.5)
    assert n == 2
    np.testing.assert_array_equal(
        shard.rows[3], np.array([1 - 0.5 * 0.5 * 3] * 2, np.float32))
    np.testing.assert_array_equal(
        shard.rows[5], np.array([1 - 0.5 * 0.5 * 1] * 2, np.float32))
    monkeypatch.setenv("TOS_EMBED_DEDUP", "0")
    shard2 = EmbeddingShard(plan, 0, np.ones((8, 2), np.float32))
    table2 = ShardedTable(shard2, None)
    np.testing.assert_array_equal(table2.lookup(ids), out)
    table2.apply_gradients(ids, grads, lr=0.5, scale=0.5)
    np.testing.assert_array_equal(shard2.rows, shard.rows)


def test_maybe_checkpoint_every_knob(tmp_path, monkeypatch):
    plan = ShardPlan.even("t", 4, 2, 1)
    table = ShardedTable(EmbeddingShard.create(plan, 0, seed=0), None)
    assert table.maybe_checkpoint(str(tmp_path), 3) is False  # disabled
    monkeypatch.setenv("TOS_EMBED_CKPT_EVERY", "2")
    assert table.maybe_checkpoint(str(tmp_path), 3) is False
    assert table.maybe_checkpoint(str(tmp_path), 4) is True
    assert latest_embedding_step(str(tmp_path), "t") == 4


# -- wide_deep dense-model plumbing -------------------------------------------


def test_wide_deep_dense_ids_and_registry():
    from tensorflowonspark_torch.models.registry import build
    from tensorflowonspark_tpu.models import wide_deep as jwd

    config = {"model": "wide_deep_dense", "vocab_size": 97, "embed_dim": 4}
    assert wide_deep.table_total_rows(config) == 26 * 97
    feats = torch_mapfuns.criteo_batch(0, 0, 4)["features"]
    ids = wide_deep.flat_categorical_ids(feats, 97)
    assert ids.shape == (4, 26) and ids.dtype == np.int64
    for c in range(26):
        assert (ids[:, c] // 97 == c).all()
    np.testing.assert_array_equal(ids, jwd.flat_categorical_ids(feats, 97))
    model = build(config)
    assert model.vocab_size == 97 and model.embed_dim == 4


def test_wide_deep_monolithic_vocab_plumbed():
    from tensorflowonspark_torch.models.registry import build

    model = build({"model": "wide_deep", "vocab_size": 1009})
    assert model.vocab_size == 1009


def test_id_fn_and_sharded_apply_on_the_cpu():
    """``make_id_fn`` gives the router the fused-table ids, and
    ``build_sharded_apply`` scores the dense half on the asked device."""
    from tensorflowonspark_torch.convert import torch_to_flax
    from tensorflowonspark_torch.embedding.serve import (
        build_sharded_apply,
        make_id_fn,
    )

    config = {"model": "wide_deep_dense", "vocab_size": 97, "embed_dim": 4,
              "hidden": (8,), "bf16": False}
    feats = torch_mapfuns.criteo_batch(0, 1, 5)["features"]
    np.testing.assert_array_equal(make_id_fn(config)(feats),
                                  wide_deep.flat_categorical_ids(feats, 97))
    with pytest.raises(ValueError, match="no sharded-embedding id extractor"):
        make_id_fn({"model": "linear"})
    model = wide_deep.build_wide_deep_dense(config)
    wide_deep.init_dense_params(model, torch.Generator().manual_seed(0))
    rows = init_rows(5 * 26, 5, 0, 5 * 26, seed=1).reshape(5, 26, 5)
    apply = build_sharded_apply(config, device="cpu")
    out = apply(torch_to_flax(model.state_dict(), config=config), feats, rows)
    assert out.device.type == "cpu"
    with torch.no_grad():
        want = model(torch.from_numpy(feats), torch.from_numpy(rows))
    torch.testing.assert_close(out, want, rtol=0, atol=0)


# -- cluster: sparse collectives ----------------------------------------------


def test_sparse_collectives_cluster_probe(tmp_path):
    cluster = tcluster.run(
        torch_mapfuns.embedding_probe, {}, num_executors=2,
        input_mode=tcluster.InputMode.STREAMING,
        launcher=SubprocessLauncher(), log_dir=str(tmp_path),
        reservation_timeout=120.0)
    cluster.shutdown(timeout=180.0)
    probes = {m["executor_id"]: m.get("embed_probe")
              for m in cluster.coordinator.cluster_info()}
    assert all(p is not None for p in probes.values()), probes
    plan = ShardPlan.even("probe", 40, 3, 2)
    for eid, p in probes.items():
        r = p["rank"]
        assert p["world"] == 2 and r == eid
        assert p["echo_ids"] == [[s * 100 + r] for s in range(2)]
        lo, hi = plan.range_of(r)
        expect = {}
        for src in range(2):
            for i in (1, 1, 30 + src, 7):
                if lo <= i < hi:
                    expect[i] = expect.get(i, 0.0) + float(src + 1)
        got = dict(zip(p["got_ids"], [row[0] for row in p["got_rows"]]))
        assert got == dict(sorted(expect.items())), (r, got, expect)
        for row in p["got_rows"]:
            assert row == [row[0]] * 3
        assert p["dense_match"] is True
        if lo <= 0 < hi:
            assert p["empty_ids"] == [0, 2]
        else:
            assert p["empty_ids"] == []
            assert p["empty_shape"] == [0, 3]


# -- cluster: 2-node sharded run == single-process reference ------------------


WD_CONFIG = {"model": "wide_deep_dense", "vocab_size": 97, "embed_dim": 4,
             "hidden": (8,), "bf16": False}


def _reference_sharded_run(config, steps, bsz, table_seed, lr=0.125, ranks=2):
    """The port's single-process unsharded replay of the SAME per-node batch
    schedule: a world-1 table (plain gathers and updates over the whole
    table), the dense gradients combined as the ring's world-2 mean does
    ((a + b) / 2 in float32, commutative-exact), the row gradients through
    the same two-level rank-order ``combine_csr`` the reduce-scatter pins,
    and the same torch SGD step.  Returns (model, shard, losses, params0)
    with ``params0`` the dense half's initial weights in the JAX layout."""
    from tensorflowonspark_torch.convert import torch_to_flax

    dim = int(config["embed_dim"]) + 1
    plan = ShardPlan.even("wide_deep", wide_deep.table_total_rows(config), dim, 1)
    model, grad_fn, opt = torch_mapfuns.dense_setup(config, lr)
    shard, table = torch_mapfuns.table_setup(plan, 0, None, table_seed)
    # torch_to_flax's arrays share the CPU tensors' memory: copy them
    params0 = copy.deepcopy(torch_to_flax(model.state_dict(), config=config))
    vocab = int(config["vocab_size"])
    losses = [[] for _ in range(ranks)]
    scale = np.float32(1.0 / ranks)
    for step in range(steps):
        per_rank = []
        for r in range(ranks):
            batch = torch_mapfuns.criteo_batch(r, step, bsz)
            ids = wide_deep.flat_categorical_ids(batch["features"], vocab)
            (loss, _aux), (dg, rg) = grad_fn(model, table.lookup(ids), batch)
            per_rank.append((ids, rg.numpy(), dg))
            losses[r].append(float(loss))
        for name, p in model.named_parameters():
            a, b = (per_rank[i][2][name].numpy() for i in range(2))
            p.grad = torch.from_numpy((a + b) / np.float32(ranks))
        opt.step()
        locals_ = [cops.combine_csr([ids], [g.reshape(ids.size, dim)], dim)
                   for ids, g, _ in per_rank]
        cu, ca = cops.combine_csr([u for u, _ in locals_],
                                  [a for _, a in locals_], dim)
        shard.apply_grad_rows(cu, ca * scale, lr)
    return model, shard, losses, params0


def _jax_reference_run(config, steps, bsz, table_seed, params0, lr=0.125,
                       ranks=2):
    """The JAX package's replay of the same schedule (its test's reference)
    from the port's initial dense weights."""
    import jax
    import optax

    from tensorflowonspark_tpu.collective import ops as jcops
    from tensorflowonspark_tpu.embedding import EmbeddingShard as JShard
    from tensorflowonspark_tpu.embedding import ShardedTable as JTable
    from tensorflowonspark_tpu.embedding import ShardPlan as JPlan
    from tensorflowonspark_tpu.models import wide_deep as jwd

    dim = int(config["embed_dim"]) + 1
    plan = JPlan.even("wide_deep", jwd.table_total_rows(config), dim, 1)
    shard = JShard.create(plan, 0, seed=table_seed, zero_cols=(dim - 1,))
    table = JTable(shard, None)
    model = jwd.build_wide_deep_dense(config)
    grad_fn = jwd.make_sharded_grad_fn(model)
    params = params0
    optimizer = optax.sgd(lr)
    opt_state = optimizer.init(params)
    vocab = int(config["vocab_size"])
    losses = [[] for _ in range(ranks)]
    for step in range(steps):
        per_rank = []
        for r in range(ranks):
            batch = torch_mapfuns.criteo_batch(r, step, bsz)
            ids = jwd.flat_categorical_ids(batch["features"], vocab)
            (loss, _aux), (dg, rg) = grad_fn(params, table.lookup(ids), batch)
            per_rank.append((ids, np.asarray(jax.device_get(rg)), dg))
            losses[r].append(float(loss))
        dg = jax.tree.map(lambda a, b: (np.asarray(a) + np.asarray(b)) / np.float32(ranks),
                          per_rank[0][2], per_rank[1][2])
        updates, opt_state = optimizer.update(dg, opt_state, params)
        params = optax.apply_updates(params, updates)
        locals_ = [jcops.combine_csr([ids], [g.reshape(ids.size, dim)], dim)
                   for ids, g, _ in per_rank]
        cu, ca = jcops.combine_csr([u for u, _ in locals_],
                                   [a for _, a in locals_], dim)
        shard.apply_grad_rows(cu, ca * np.float32(1.0 / ranks), lr)
    return jax.device_get(params), shard, losses


def test_sharded_train_matches_single_process_bitwise(tmp_path):
    """2-node sharded wide-and-deep sync training == the port's
    single-process unsharded reference, bit for bit — digests of the dense
    half AND of each node's table range, and the per-step losses; the
    reference in turn within the stated tolerance of the JAX package's."""
    from tensorflowonspark_torch.checkpoint import _flatten_tree

    steps, bsz, table_seed = 4, 8, 11
    cluster = tcluster.run(
        torch_mapfuns.train_wide_deep_sharded,
        {"model_config": WD_CONFIG, "steps": steps, "batch_size": bsz,
         "table_seed": table_seed, "device": "cpu"},
        num_executors=2, input_mode=tcluster.InputMode.STREAMING,
        launcher=SubprocessLauncher(), log_dir=str(tmp_path),
        reservation_timeout=120.0)
    cluster.shutdown(timeout=300.0)
    metas = {m["executor_id"]: m.get("sharded_train")
             for m in cluster.coordinator.cluster_info()}
    assert all(v is not None for v in metas.values()), metas

    model, ref_shard, ref_losses, params0 = _reference_sharded_run(
        WD_CONFIG, steps, bsz, table_seed)
    ref_dense = torch_mapfuns.dense_digest(model, WD_CONFIG)
    plan = ref_shard.plan.reshard(2)
    for eid, meta in metas.items():
        assert meta["steps"] == steps
        assert meta["losses"] == ref_losses[eid]
        assert meta["dense_digest"] == ref_dense
        lo, hi = plan.range_of(eid)
        assert meta["shard_range"] == [lo, hi]
        assert meta["shard_digest"] == torch_mapfuns.tree_digest(
            {"rows": ref_shard.rows[lo:hi]})
        assert meta["stats"]["ids_sent"] > 0
        assert meta["stats"]["grad_rows_sent"] > 0
        assert meta["stats"]["lookups"] == steps

    jparams, jshard, jlosses = _jax_reference_run(
        WD_CONFIG, steps, bsz, table_seed, params0)
    np.testing.assert_allclose(ref_losses, jlosses, rtol=1e-5)
    from tensorflowonspark_torch.convert import torch_to_flax

    got = _flatten_tree(torch_to_flax(model.state_dict(), config=WD_CONFIG))
    want = _flatten_tree(jparams)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(ref_shard.rows, jshard.rows, rtol=1e-5, atol=1e-7)


# -- cluster: SIGKILL a shard owner mid-step ----------------------------------


def test_sharded_embed_chaos_kill_shard_owner(tmp_path, monkeypatch):
    """SIGKILL the node owning the upper shard range mid-sync-step: the
    survivor aborts the poisoned round, the supervised restart rejoins at
    the generation barrier, everyone min-votes the newest complete
    (shard + dense) checkpoint, restores, and replays — exact step
    accounting and digests equal to the fault-free reference."""
    monkeypatch.setenv("TOS_DEAD_NODE_TIMEOUT", "3")
    config = {"model": "wide_deep_dense", "vocab_size": 53, "embed_dim": 3,
              "hidden": (8,), "bf16": False}
    steps, bsz = 4, 8
    model_dir = str(tmp_path / "ckpt")
    os.makedirs(model_dir, exist_ok=True)
    cluster = tcluster.run(
        torch_mapfuns.sharded_embed_chaos,
        {"model_config": config, "steps": steps, "batch_size": bsz,
         "model_dir": model_dir},
        num_executors=2, input_mode=tcluster.InputMode.STREAMING,
        launcher=SubprocessLauncher(), log_dir=str(tmp_path),
        heartbeat_interval=0.5, elastic=True,
        env={"TOS_FAULTINJECT":
             "kill_collective:after_rounds=3,executor=1,incarnation=0"},
        reservation_timeout=120.0)
    deadline = time.monotonic() + 240.0
    metas = {}
    while time.monotonic() < deadline:
        metas = {m["executor_id"]: m.get("embed_chaos")
                 for m in cluster.coordinator.cluster_info()}
        if all(v is not None for v in metas.values()):
            break
        time.sleep(0.5)
    cluster.shutdown(timeout=300.0)
    assert all(v is not None for v in metas.values()), metas

    model, ref_shard, _losses, _p0 = _reference_sharded_run(
        config, steps, bsz, table_seed=5)
    ref_dense = torch_mapfuns.dense_digest(model, config)
    plan = ref_shard.plan.reshard(2)
    assert metas[1]["incarnation"] == 1          # the victim restarted
    assert max(m["reforms"] for m in metas.values()) >= 1
    assert max(m["generation"] for m in metas.values()) >= 2
    for eid, meta in metas.items():
        assert meta["steps"] == steps            # exact step accounting
        assert meta["dense_digest"] == ref_dense
        lo, hi = plan.range_of(eid)
        assert meta["shard_digest"] == torch_mapfuns.tree_digest(
            {"rows": ref_shard.rows[lo:hi]})
    assert cluster.supervisor.restart_count(1) == 1


# -- pipeline + serving: estimator-driven sharded train -> gateway ------------


def test_estimator_sharded_train_and_gateway_serving(tmp_path):
    """The whole tier end to end: ``TorchEstimator`` drives a sync sharded
    train over streamed synthetic-Criteo rows (the embedding plan rides the
    manifest), the export carries the dense bundle + per-node shard files,
    and a fresh 2-replica serve cluster answers through the gateway's
    lookup fan-out — predictions equal the JAX dense apply over the
    reassembled table."""
    from tensorflowonspark_torch import pipeline, serving
    from tensorflowonspark_torch.checkpoint import load_bundle
    from tensorflowonspark_torch.data import PartitionedDataset
    from tensorflowonspark_tpu.models import wide_deep as jwd

    config = {"model": "wide_deep_dense", "vocab_size": 101, "embed_dim": 4,
              "hidden": (8,), "bf16": False}
    dim = int(config["embed_dim"]) + 1
    plan = ShardPlan.even("wide_deep", wide_deep.table_total_rows(config), dim, 2)
    export = str(tmp_path / "export")
    rows = wide_deep.synthetic_criteo(64, seed=3)
    est = pipeline.TorchEstimator(
        torch_mapfuns.estimator_wide_deep_sharded,
        {"model_config": config, "lr": 0.125, "device": "cpu"})
    est.setNumExecutors(2).setEpochs(1).setBatchSize(8)
    est.set("export_dir", export)
    est.set("log_dir", str(tmp_path / "logs"))
    est.set("train_mode", "sync")
    est.set("embedding_plan", plan.to_manifest())
    est.set("steps", 3)
    est.fit(PartitionedDataset.from_iterable(rows, 2))

    with open(os.path.join(export, "bundle.json")) as f:
        bundle_config = json.load(f)
    block = bundle_config["sharded_embedding"]
    assert block["name"] == "wide_deep"
    assert block["total_rows"] == plan.total_rows and block["dim"] == dim
    full_rows = restore_embedding_shard(export, "wide_deep", block["step"],
                                        0, plan.total_rows, dim)
    metas = {m["executor_id"]: m.get("sharded_train")
             for m in est.last_cluster_info}
    assert all(v is not None for v in metas.values()), metas
    for meta in metas.values():
        assert meta["manifest_embedding"] == plan.to_manifest()
        assert meta["stats"]["ids_sent"] > 0
        assert meta["steps"] == 3

    serve_cluster = tcluster.run(
        serving.serving_loop, {"export_dir": export, "max_batch": 8,
                               "device": "cpu"},
        num_executors=2, input_mode=tcluster.InputMode.STREAMING,
        queues=("input", "output", "error", "embed", "embed_out"),
        launcher=SubprocessLauncher(), log_dir=str(tmp_path),
        heartbeat_interval=0.5, reservation_timeout=120.0)
    try:
        gw = serve_cluster.serve(export, max_batch=8, max_delay_ms=5.0,
                                 reload_poll_secs=0)
        query = [np.asarray(r["features"], np.float32)
                 for r in wide_deep.synthetic_criteo(6, seed=99)]
        out = gw.predict(query, timeout=120.0)
        assert len(out) == 6
        params, _cfg = load_bundle(export)
        feats = np.stack(query)
        emb = full_rows[wide_deep.flat_categorical_ids(feats, 101)]
        expect = np.asarray(jwd.build_wide_deep_dense(config).apply(
            {"params": params}, feats, emb))
        np.testing.assert_allclose(np.asarray([float(o) for o in out]),
                                   expect, rtol=1e-5, atol=1e-6)
        counters = serve_cluster.metrics().get("counters") or {}
        assert counters.get("serve.embed_fanouts", 0) >= 1
    finally:
        serve_cluster.shutdown(timeout=300.0)
