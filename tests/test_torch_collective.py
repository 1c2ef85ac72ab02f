"""The port's cross-host collectives (``tensorflowonspark_torch/collective``)
on the CPU: the restated units of ``tests/test_collective.py`` (inbox and
membership fencing, ``form``, the bucket plan, integer promotion, the
suspect/quorum/probation ladder on the port's coordinator), the torch
trees the gradient hook carries (leaves back in their own kind, device and
dtype; bfloat16 summed in float32), and real node processes: every
primitive on 3 nodes with exact integer-valued results, 2-node
``mode="sync"`` training against the JAX package's single-process step on
the same data order, and the SIGKILL mid-all-reduce rejoin.

Tolerances: the collective results and the chaos run's two nodes are exact;
the sync run against the JAX single-process step is held at rtol 1e-5 (the
two-node mean of two 4-row means against one 8-row mean in another
framework: float32 rounding in other orders), and the chaos run against its
numpy replay at rtol 1e-4, as the JAX package's test holds it.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import pytest
import torch

from tensorflowonspark_torch import cluster as tcluster
from tensorflowonspark_torch.collective import group as cgroup
from tensorflowonspark_torch.collective.group import _plan_buckets
from tensorflowonspark_torch.collective.transport import (
    CollectiveAborted,
    CollectiveInbox,
    CollectiveTimeout,
)
from tensorflowonspark_torch.coordinator import CoordinatorServer, _reduce
from tensorflowonspark_torch.launcher import SubprocessLauncher
from torch_lock_gate import torch_lock_witness_gate  # noqa: F401 - the port's lock-witness gate

from tests import torch_mapfuns


# -- inbox / fencing units ----------------------------------------------------


def test_inbox_delivers_and_orders_by_key():
    box = CollectiveInbox("t")
    box.advance_generation(1)
    box.deliver(1, 0, 1, ("rs", 0, 0), np.arange(3))
    box.deliver(1, 0, 1, ("rs", 0, 1), np.arange(3) + 10)
    got = box.recv(1, 0, 1, ("rs", 0, 1), timeout=1.0)
    assert got.tolist() == [10, 11, 12]
    got = box.recv(1, 0, 1, ("rs", 0, 0), timeout=1.0)
    assert got.tolist() == [0, 1, 2]


def test_inbox_drops_stale_generation_buffers_ahead():
    box = CollectiveInbox("t")
    box.advance_generation(2)
    box.deliver(1, 0, 1, "x", "stale")     # fenced: dropped
    box.deliver(3, 0, 1, "x", "ahead")     # buffered for the next gen
    with pytest.raises(CollectiveAborted, match="timed out"):
        box.recv(2, 0, 1, "x", timeout=0.1)
    box.advance_generation(3)
    assert box.recv(3, 0, 1, "x", timeout=1.0) == "ahead"


def test_inbox_peer_failure_poisons_waiters_fast():
    box = CollectiveInbox("t")
    box.advance_generation(1)
    errs: list[Exception] = []

    def waiter():
        try:
            box.recv(1, 2, 1, "x", timeout=30.0)
        except CollectiveAborted as e:
            errs.append(e)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.1)
    t0 = time.monotonic()
    box.fail_peer(2, 1)
    t.join(timeout=5.0)
    assert not t.is_alive() and len(errs) == 1
    assert time.monotonic() - t0 < 2.0  # poisoned, not timed out
    # a HIGHER generation is a new connection: unaffected by the failure
    box.advance_generation(2)
    box.deliver(2, 2, 1, "x", "fresh")
    assert box.recv(2, 2, 1, "x", timeout=1.0) == "fresh"


def test_form_reduce_kind_assigns_ranks_and_maxes():
    out = _reduce("form", [
        {"eid": 3, "host": "h3", "port": 3, "gen": 1, "step": 4},
        {"eid": 1, "host": "h1", "port": 1, "gen": 2, "step": 0},
    ])
    assert [m["eid"] for m in out["members"]] == [1, 3]
    assert out["generation"] == 2 and out["step"] == 4


def test_plan_buckets_groups_by_dtype_and_size():
    leaves = [np.zeros(10, np.float32), np.zeros(10, np.float32),
              np.zeros(4, np.int32), np.zeros(1000, np.float32)]
    buckets = _plan_buckets(leaves, bucket_bytes=64)
    # order preserved, dtype change splits, oversized leaf is its own bucket
    assert buckets == [[0], [1], [2], [3]]
    big = _plan_buckets(leaves[:2], bucket_bytes=1 << 20)
    assert big == [[0, 1]]
    # tensors plan by their wire dtype: bfloat16 travels as float32, so it
    # packs with float32 leaves; float16 does not
    mixed = [torch.zeros(3), torch.zeros(3, dtype=torch.bfloat16),
             np.zeros(2, np.float32), torch.zeros(2, dtype=torch.float16)]
    assert _plan_buckets(mixed, bucket_bytes=1 << 20) == [[0, 1, 2], [3]]


def test_averaged_promotes_integer_dtypes():
    from tensorflowonspark_torch.collective.ops import _averaged

    out = _averaged(np.array([2, 4], np.int64), 2)
    assert out.tolist() == [1.0, 2.0]
    assert np.issubdtype(out.dtype, np.floating)
    f = np.array([2.0, 4.0], np.float32)
    assert _averaged(f, 2) is f and f.tolist() == [1.0, 2.0]


# -- torch trees (the port's pytrees) -----------------------------------------


def test_tree_round_trip_keeps_kinds_devices_and_passthroughs():
    """A nested dict/list/tuple tree packs into per-wire-dtype buckets and
    unpacks into leaves of each input leaf's own kind and dtype; values that
    are not arrays pass through untouched."""
    tree = {"model": {"w": torch.arange(6.0).reshape(2, 3),
                      "h": torch.arange(4, dtype=torch.float16)},
            "opt": {"state": {0: {"acc": np.full((2,), 3.0, np.float32)}},
                    "param_groups": [{"lr": 0.01, "params": [0, 1]}]},
            "pair": (torch.tensor([7], dtype=torch.int64), None),
            "step": 4}
    leaves, spec = cgroup._flatten(tree)
    assert len(leaves) == 4
    buckets = _plan_buckets(leaves, 1 << 20)
    out = list(leaves)
    for b in buckets:
        packed = cgroup._pack([leaves[i] for i in b])
        assert packed.ndim == 1
        for i, leaf in zip(b, cgroup._unpack(packed * 2, [leaves[i] for i in b])):
            out[i] = leaf
    back = cgroup._unflatten(spec, out)
    assert isinstance(back["model"]["w"], torch.Tensor)
    assert back["model"]["h"].dtype == torch.float16
    torch.testing.assert_close(back["model"]["w"], tree["model"]["w"] * 2)
    assert isinstance(back["opt"]["state"][0]["acc"], np.ndarray)
    assert back["opt"]["state"][0]["acc"].tolist() == [6.0, 6.0]
    assert back["opt"]["param_groups"] == [{"lr": 0.01, "params": [0, 1]}]
    assert isinstance(back["pair"], tuple) and back["pair"][1] is None
    assert back["pair"][0].tolist() == [14] and back["pair"][0].dtype == torch.int64
    assert back["step"] == 4
    # the input leaves are untouched (the ops copy before they write)
    torch.testing.assert_close(tree["model"]["w"], torch.arange(6.0).reshape(2, 3))


def test_bfloat16_leaves_sum_in_float32_and_round_once():
    """numpy has no bfloat16: a bf16 leaf travels as float32 (exact), the
    reduction runs in float32 and the mean rounds back to bf16 once — not
    the sum of two bf16-rounded halves."""
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(257, generator=gen).bfloat16()
    b = torch.randn(257, generator=gen).bfloat16()
    wire = [cgroup._pack([a]), cgroup._pack([b])]
    assert all(w.dtype == np.float32 for w in wire)
    np.testing.assert_array_equal(wire[0], a.float().numpy())
    mean = (wire[0] + wire[1]) / np.float32(2)            # what the ring computes
    (got,) = cgroup._unpack(mean, [a])
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, ((a.float() + b.float()) / 2).bfloat16(),
                               rtol=0, atol=0)
    # an averaged integer leaf comes back promoted, as ops._averaged makes it
    (ints,) = cgroup._unpack(np.array([1.5, 2.0]), [torch.tensor([3, 4])])
    assert ints.dtype == torch.float64 and ints.tolist() == [1.5, 2.0]


def test_make_train_step_hook_applied_once_and_lands_in_grad():
    """The ``cross_host_grad_fn`` hook (a copy of what all_reduce_tree
    returns: new tensors) is called once per step with the ``{name: grad}``
    dict; its tensors become ``p.grad`` on the parameter's device, and the
    trajectory equals the unhooked step's exactly."""
    from tensorflowonspark_torch.parallel import dp as tdp

    calls: list[dict] = []

    def hook(grads):
        calls.append(grads)
        return {n: g.detach().clone() for n, g in grads.items()}

    batch = {"x": np.arange(12, dtype=np.float32).reshape(4, 3) % 5,
             "y": np.arange(4, dtype=np.float32)}
    plain = torch_mapfuns._linear_state(0.5, True, 0.1)
    hooked = torch_mapfuns._linear_state(0.5, True, 0.1)
    step_plain = tdp.make_train_step(torch_mapfuns._mse, plain.optimizer)
    step_hooked = tdp.make_train_step(torch_mapfuns._mse, hooked.optimizer,
                                      cross_host_grad_fn=hook)
    for _ in range(3):
        plain, m_plain = step_plain(plain, batch)
        hooked, m_hooked = step_hooked(hooked, batch)
        assert m_plain["loss"].item() == m_hooked["loss"].item()
    assert len(calls) == 3 and set(calls[0]) == {"weight", "bias"}
    w = hooked.model.weight
    assert w.grad is not calls[-1]["weight"] and w.grad.device == w.device
    torch.testing.assert_close(w, plain.model.weight, rtol=0, atol=0)
    assert hooked.step == 3


# -- multi-node collective results (exact) ------------------------------------


def test_collective_ops_three_nodes_exact(tmp_path):
    cluster = tcluster.run(
        torch_mapfuns.collective_ops_probe, {}, num_executors=3,
        input_mode=tcluster.InputMode.STREAMING,
        launcher=SubprocessLauncher(), log_dir=str(tmp_path),
        reservation_timeout=120.0)
    cluster.shutdown(timeout=180.0)
    probes = {m["executor_id"]: m.get("probe")
              for m in cluster.coordinator.cluster_info()}
    assert all(p is not None for p in probes.values()), probes
    base = np.arange(6, dtype=np.float32).reshape(2, 3)
    expect_sum = (3 * base + 6.0).tolist()          # sum of base + r + 1
    expect_mean = (base + 2.0).tolist()
    gathered_expect = [[float(r)] * (2 + r) for r in range(3)]
    seg_sum = np.arange(8, dtype=np.float32) * 6.0  # (1+2+3) x arange
    seg_bounds = [0, 2, 5, 8]
    for eid, p in probes.items():
        assert p["world"] == 3 and p["rank"] == eid
        assert p["generation"] >= 1
        assert p["ring"] == expect_sum
        assert p["naive"] == expect_sum
        assert p["mean"] == expect_mean
        assert p["bcast"] == [8.0] * 5
        assert p["gathered"] == gathered_expect
        own = (p["rank"] + 1) % 3
        assert p["seg_idx"] == own
        assert p["seg"] == seg_sum[seg_bounds[own]:seg_bounds[own + 1]].tolist()


# -- sync training: 2-node trajectory == single-process equivalent ------------


def _sync_rows(rank: int, steps: int, batch_size: int):
    """Partition content for node ``rank``: deterministic (x, y) rows,
    integer-valued floats, in a pinned order."""
    rows = []
    for s in range(steps):
        for i in range(batch_size):
            j = s * batch_size + i
            x = [(j * (rank + 2) + k) % 7 for k in range(3)]
            y = (j + rank) % 4
            rows.append(([float(v) for v in x], float(y)))
    return rows


def test_sync_train_matches_single_process(tmp_path):
    """2-node ``mode="sync"`` training through ``ctx.collective_group()``'s
    gradient hook matches the JAX package's single-process step over the
    concatenated batch on the same data order (mean over 2B == the average
    of the two B-row means at equal sizes)."""
    import jax
    import jax.numpy as jnp
    import optax

    from tensorflowonspark_tpu.parallel import dp as jdp

    steps, bsz = 4, 4
    parts = [_sync_rows(0, steps, bsz), _sync_rows(1, steps, bsz)]
    cluster = tcluster.run(
        torch_mapfuns.train_sync_collective, {"batch_size": bsz, "device": "cpu"},
        num_executors=2, input_mode=tcluster.InputMode.STREAMING,
        launcher=SubprocessLauncher(), log_dir=str(tmp_path),
        reservation_timeout=120.0)
    cluster.train(parts, mode="sync")
    cluster.shutdown(timeout=180.0)
    metas = {m["executor_id"]: m.get("sync_train")
             for m in cluster.coordinator.cluster_info()}
    assert all(v is not None for v in metas.values()), metas
    for v in metas.values():
        assert v["manifest_mode"] == "sync"
        assert v["manifest_sync"] == {"group": "train", "world": 2}
        assert v["steps"] == steps and len(v["losses"]) == steps
        assert v["grad_device"] == "cpu"
    # both nodes applied identical reduced gradients -> identical params
    assert metas[0]["final_w"] == metas[1]["final_w"]
    assert metas[0]["final_b"] == metas[1]["final_b"]

    def loss_fn(p, batch):
        pred = batch["x"] @ p["w"] + p["b"]
        err = pred[:, 0] - batch["y"]
        return jnp.mean(err * err), {}

    optimizer = optax.sgd(0.1)
    state = jdp.TrainState.create(
        {"w": np.full((3, 1), 0.5, np.float32),
         "b": np.zeros((1,), np.float32)}, optimizer)
    ref = jdp.make_train_step(loss_fn, optimizer, donate=False)
    ref_losses = []
    for s in range(steps):
        rows = (parts[0][s * bsz:(s + 1) * bsz]
                + parts[1][s * bsz:(s + 1) * bsz])
        batch = {"x": np.asarray([r[0] for r in rows], np.float32),
                 "y": np.asarray([r[1] for r in rows], np.float32)}
        state, metrics = ref(state, batch)
        ref_losses.append(float(metrics["loss"]))
    sync_losses = [(metas[0]["losses"][s] + metas[1]["losses"][s]) / 2.0
                   for s in range(steps)]
    np.testing.assert_allclose(sync_losses, ref_losses, rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(metas[0]["final_w"], np.float32),
        np.asarray(jax.device_get(state.params["w"])).ravel(), rtol=1e-5)
    np.testing.assert_allclose(metas[0]["final_b"],
                               float(np.asarray(state.params["b"])[0]),
                               rtol=1e-5, atol=1e-7)


# -- chaos: SIGKILL mid-all-reduce, generation-barrier rejoin -----------------


def test_chaos_kill_mid_allreduce_rejoins_exact_steps(tmp_path, monkeypatch):
    """SIGKILL one node inside an all-reduce — no hang, no corrupted
    gradients.  Survivors fence the generation and abort the poisoned
    round; the supervised restart rejoins at the generation barrier;
    ``sync_state`` levels its ``TrainState`` onto the survivor's step; the
    run completes with EXACT step accounting and final params equal to the
    fault-free reference."""
    monkeypatch.setenv("TOS_DEAD_NODE_TIMEOUT", "3")
    total_steps = 6
    cluster = tcluster.run(
        torch_mapfuns.sync_collective_chaos, {"steps": total_steps},
        num_executors=2, input_mode=tcluster.InputMode.STREAMING,
        launcher=SubprocessLauncher(), log_dir=str(tmp_path),
        heartbeat_interval=0.5, elastic=True,
        # executor 1 dies inside its 3rd all-reduce (after the first chunk
        # exchange); incarnation=0 disarms the replacement
        env={"TOS_FAULTINJECT":
             "kill_collective:after_rounds=3,executor=1,incarnation=0"},
        reservation_timeout=120.0)
    # no train() feed blocks this map_fun: wait for the chaos cycle before
    # shutdown (shutdown stops the supervisor)
    deadline = time.monotonic() + 240.0
    metas: dict = {}
    while time.monotonic() < deadline:
        metas = {m["executor_id"]: m.get("chaos_sync")
                 for m in cluster.coordinator.cluster_info()}
        if all(v is not None for v in metas.values()):
            break
        time.sleep(0.5)
    cluster.shutdown(timeout=300.0)
    assert all(v is not None for v in metas.values()), metas
    for v in metas.values():
        assert v["steps"] == total_steps
        assert v["generation"] >= 2
    assert metas[0]["reforms"] >= 1
    assert metas[1]["incarnation"] == 1  # the publishing node 1 IS a restart
    assert metas[0]["final_w"] == metas[1]["final_w"]
    w = np.full((3, 1), 0.25, np.float32)
    for s in range(total_steps):
        grads = []
        for rank in range(2):
            b = torch_mapfuns.chaos_batch(rank, s)
            err = (b["x"] @ w)[:, 0] - b["y"]
            grads.append((2.0 / len(err)) * (b["x"].T @ err)[:, None])
        w = w - np.float32(0.125) * ((grads[0] + grads[1]) / 2.0)
    np.testing.assert_allclose(np.asarray(metas[0]["final_w"]),
                               w.ravel(), rtol=1e-4)
    counters = (cluster.metrics().get("counters") or {})
    assert counters.get("collective.aborts_total", 0) >= 1
    assert counters.get("collective.reforms_total", 0) >= 1
    assert cluster.supervisor is not None
    assert cluster.supervisor.restart_count(1) == 1


# -- gray failures: detection / quorum eviction units -------------------------


def _form_three(srv):
    """Drive a 3-member `form` rendezvous straight through _dispatch."""
    for i in range(3):
        assert srv._dispatch({"op": "register",
                              "meta": {"host": f"h{i}",
                                       "data_port": 1000 + i}})["ok"]
    results = {}

    def join(eid):
        results[eid] = srv._dispatch({
            "op": "reduce", "name": "cg.train.form", "kind": "form",
            "value": {"eid": eid, "host": f"h{eid}", "port": 1000 + eid,
                      "gen": 1, "step": 0},
            "count": 3, "executor_id": eid, "incarnation": 0,
            "timeout": 10.0})

    threads = [threading.Thread(target=join, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
    assert all(r["ok"] for r in results.values()), results


def test_suspect_quorum_evicts_with_transitive_blame(monkeypatch):
    """Transitive blame lands on the one member that is blamed but not
    blaming, and it is evicted once quorum survives the confirmation hold:
    its incarnation is fenced and the probation clock starts."""
    from tensorflowonspark_torch import coordinator as coord_mod

    monkeypatch.setenv("TOS_COLLECTIVE_PROBATION_SECS", "600")
    monkeypatch.setattr(coord_mod, "_EVICT_CONFIRM_SECS", 0.15)
    srv = CoordinatorServer(3)
    try:
        _form_three(srv)
        r = srv._dispatch({"op": "suspect", "group": "train", "suspect": 1,
                           "wait_secs": 2.0, "executor_id": 2,
                           "incarnation": 0})
        assert r["ok"] and r["evicted"] == []
        r = srv._dispatch({"op": "suspect", "group": "train", "suspect": 2,
                           "wait_secs": 2.0, "executor_id": 0,
                           "incarnation": 0})
        assert r["evicted"] == []
        time.sleep(0.2)
        r = srv._dispatch({"op": "suspect", "group": "train", "suspect": 1,
                           "wait_secs": 3.0, "executor_id": 2,
                           "incarnation": 0})
        assert r["evicted"] == [1]
        assert srv.registered_incarnation(1) == (1, False)  # fenced, benched
        assert 1 in srv.evicted_members()
        assert [e["eid"] for e in srv.evictions()] == [1]
        assert srv._dispatch({"op": "cworld", "group": "train",
                              "world": 3})["effective"] == 2
        hb = srv._dispatch({"op": "heartbeat", "executor_id": 1,
                            "incarnation": 0})
        assert hb["ok"] and hb["evicted"] and not hb["stop"]
        r = srv._dispatch({"op": "reduce", "name": "cg.train.form",
                           "kind": "form", "value": {"eid": 1}, "count": 2,
                           "executor_id": 1, "incarnation": 0,
                           "timeout": 0.5})
        assert not r["ok"] and r.get("fenced") and r.get("evicted")
        r = srv._dispatch({"op": "register", "meta": {"host": "h9"},
                           "replace": 1})
        assert not r["ok"] and "probation" in r["error"]
    finally:
        srv.stop()


def test_uniform_slowness_blame_cycle_never_evicts(monkeypatch):
    from tensorflowonspark_torch import coordinator as coord_mod

    monkeypatch.setattr(coord_mod, "_EVICT_CONFIRM_SECS", 0.15)
    srv = CoordinatorServer(3)
    try:
        _form_three(srv)
        for voter, blamed in ((0, 2), (2, 1), (1, 0)):
            r = srv._dispatch({"op": "suspect", "group": "train",
                               "suspect": blamed, "wait_secs": 1.0,
                               "executor_id": voter, "incarnation": 0})
            assert r["ok"] and r["evicted"] == [], r
        time.sleep(0.2)
        for voter, blamed in ((0, 2), (2, 1), (1, 0)):
            r = srv._dispatch({"op": "suspect", "group": "train",
                               "suspect": blamed, "wait_secs": 2.0,
                               "executor_id": voter, "incarnation": 0})
            assert r["ok"] and r["evicted"] == [], r
        assert srv.evicted_members() == {}
        assert srv.evictions() == []
    finally:
        srv.stop()


def test_min_world_floor_refuses_eviction(monkeypatch):
    monkeypatch.setenv("TOS_COLLECTIVE_MIN_WORLD", "3")
    srv = CoordinatorServer(3)
    try:
        _form_three(srv)
        for voter in (0, 2):
            r = srv._dispatch({"op": "suspect", "group": "train",
                               "suspect": 1, "wait_secs": 5.0,
                               "executor_id": voter, "incarnation": 0})
            assert r["evicted"] == []
        assert srv.evicted_members() == {}
    finally:
        srv.stop()


def test_probation_readmit_hands_back_incarnation(monkeypatch):
    from tensorflowonspark_torch import coordinator as coord_mod

    monkeypatch.setenv("TOS_COLLECTIVE_PROBATION_SECS", "0.2")
    monkeypatch.setattr(coord_mod, "_EVICT_CONFIRM_SECS", 0.0)
    srv = CoordinatorServer(3)
    try:
        _form_three(srv)
        for voter, blamed in ((2, 1), (0, 1)):
            srv._dispatch({"op": "suspect", "group": "train",
                           "suspect": blamed, "wait_secs": 3.0,
                           "executor_id": voter, "incarnation": 0})
        assert 1 in srv.evicted_members()
        time.sleep(0.25)
        hb = srv._dispatch({"op": "heartbeat", "executor_id": 1,
                            "incarnation": 0})
        assert hb["ok"] and not hb.get("evicted")
        assert hb.get("readmit_incarnation") == 1
        assert srv.registered_incarnation(1) == (1, True)
        r = srv._dispatch({"op": "update_meta", "executor_id": 1,
                           "incarnation": 0, "patch": {"x": 1}})
        assert r["ok"] and r.get("readmit_incarnation") == 1
        r = srv._dispatch({"op": "heartbeat", "executor_id": 1,
                           "incarnation": 1})
        assert r["ok"] and "readmit_incarnation" not in r
        assert srv._dispatch({"op": "cworld", "group": "train",
                              "world": 3})["effective"] == 3
        events = srv.drain_collective_events()
        assert [e["kind"] for e in events] == ["evicted", "readmitted"]
    finally:
        srv.stop()


def test_inbox_membership_fence_and_attach_severing():
    import socket as socketlib

    from tensorflowonspark_torch.collective import transport as ctransport

    box = CollectiveInbox("t")
    box.advance_generation(2, member_eids=[0, 2])
    box.deliver(2, 2, 1, "x", "zombie")
    with pytest.raises(CollectiveTimeout):
        box.recv(2, 2, 1, "x", timeout=0.05)
    box.deliver(2, 0, 1, "x", "fresh")
    assert box.recv(2, 0, 1, "x", timeout=1.0) == "fresh"
    assert not box.admits(1, 2)
    assert box.admits(1, 3)
    assert box.admits(0, 2)
    assert box.admits(-1, 0)
    a, b = socketlib.socketpair()
    try:
        box.note_attach(1, a)
        box.advance_generation(3, member_eids=[0, 2])
        assert b.recv(1) == b""  # our end closed -> peer sees EOF
    finally:
        for s in (a, b):
            try:
                s.close()
            except OSError:
                pass
    ctransport.register_inbox("fence-probe", box)
    try:
        assert ctransport.attach_error("fence-probe", 1, 4) is None
        err = ctransport.attach_error("fence-probe", 1, 3)
        assert err is not None and "not a member" in err
    finally:
        ctransport.unregister_inbox("fence-probe")


def test_suspect_threshold_relative_to_baseline():
    from tensorflowonspark_torch.collective.transport import PeerTransport

    tp = PeerTransport("thresh-probe", b"k", timeout=120.0)
    try:
        assert tp.suspect_threshold(120.0) == pytest.approx(1.0)  # cold
        for _ in range(50):
            tp._note_wait(0.2)
        thr = tp.suspect_threshold(120.0)
        assert 1.2 < thr <= 0.2 * 8 * 1.2
        assert tp.suspect_threshold(4.0) == pytest.approx(1.0)  # budget cap
    finally:
        tp.close()


@pytest.mark.parametrize("spec,identity,stalls", [
    ("stall_collective:after_rounds=3,secs=7,executor=1;slow_peer:ms=25",
     (1, 0), [0.0, 0.0, 7.0, 0.0]),
    ("stall_collective:after_rounds=1", (0, 0), [300.0]),
    ("stall_collective:after_rounds=1,secs=2.5", (0, 0), [2.5]),
], ids=["gray_actions", "default_secs", "fractional_secs"])
def test_faultinject_stall_collective_parse(spec, identity, stalls):
    from tensorflowonspark_torch.faultinject import FaultPlan

    plan = FaultPlan.parse(spec)
    plan.set_identity(*identity)
    assert [plan.stall_secs() for _ in stalls] == stalls
    if "slow_peer" in spec:
        assert plan.delay_ms("slow_peer") == 25  # continuous
        assert plan.delay_ms("slow_peer") == 25


def test_faultinject_unknown_action_names_vocabulary():
    from tensorflowonspark_torch.faultinject import FaultPlan

    with pytest.raises(ValueError, match="known actions: .*stall_collective"):
        FaultPlan.parse("stall_forever:x=1")


def test_eviction_survives_coordinator_crash(tmp_path, monkeypatch):
    from tensorflowonspark_torch import coordinator as coord_mod

    monkeypatch.setenv("TOS_COLLECTIVE_PROBATION_SECS", "0.3")
    monkeypatch.setattr(coord_mod, "_EVICT_CONFIRM_SECS", 0.0)
    srv = CoordinatorServer(3, journal_path=str(tmp_path / "j"))
    try:
        _form_three(srv)
        for voter, blamed in ((2, 1), (0, 1)):
            srv._dispatch({"op": "suspect", "group": "train",
                           "suspect": blamed, "wait_secs": 3.0,
                           "executor_id": voter, "incarnation": 0})
        assert 1 in srv.evicted_members()
        srv.drain_collective_events()
        srv.crash()
        srv.restore()
        assert 1 in srv.evicted_members()
        assert {(e["kind"], e["eid"])
                for e in srv.drain_collective_events()} == {("evicted", 1)}
        assert srv.registered_incarnation(1)[0] == 1
        assert srv._dispatch({"op": "cworld", "group": "train",
                              "world": 3})["effective"] == 2
        hb = srv._dispatch({"op": "heartbeat", "executor_id": 1,
                            "incarnation": 0})
        assert hb["ok"] and hb.get("evicted") and not hb["stop"]
        time.sleep(0.35)
        hb = srv._dispatch({"op": "heartbeat", "executor_id": 1,
                            "incarnation": 0})
        assert hb["ok"] and hb.get("readmit_incarnation") == 1
        assert srv._dispatch({"op": "cworld", "group": "train",
                              "world": 3})["effective"] == 3
    finally:
        srv.stop()


def test_relearn_never_unfences_a_pre_eviction_zombie(monkeypatch):
    from tensorflowonspark_torch import coordinator as coord_mod

    monkeypatch.setenv("TOS_COLLECTIVE_PROBATION_SECS", "0.1")
    monkeypatch.setattr(coord_mod, "_EVICT_CONFIRM_SECS", 0.0)
    srv = CoordinatorServer(3)
    try:
        _form_three(srv)
        srv.mark_dead([1], record_error=False)
        r = srv._dispatch({"op": "register", "meta": {"host": "h1b"},
                           "replace": 1})
        assert r["ok"] and r["incarnation"] == 1
        for voter, blamed in ((2, 1), (0, 1)):
            srv._dispatch({"op": "suspect", "group": "train",
                           "suspect": blamed, "wait_secs": 3.0,
                           "executor_id": voter, "incarnation": 0})
        assert 1 in srv.evicted_members()
        before = srv.evicted_members()[1]["last_ping"]
        hb = srv._dispatch({"op": "heartbeat", "executor_id": 1,
                            "incarnation": 0})
        assert hb.get("fenced") and hb["stop"] and not hb.get("evicted")
        assert srv.evicted_members()[1]["last_ping"] == before
        time.sleep(0.15)
        hb = srv._dispatch({"op": "heartbeat", "executor_id": 1,
                            "incarnation": 0})
        assert hb.get("fenced") and hb["stop"]
        assert 1 in srv.evicted_members()
        hb = srv._dispatch({"op": "heartbeat", "executor_id": 1,
                            "incarnation": 1,
                            "metrics": {"counters": {"probe.alive": 7}}})
        assert hb.get("readmit_incarnation") == 2
        r = srv._dispatch({"op": "update_meta", "executor_id": 1,
                           "incarnation": 1, "patch": {}})
        assert r["ok"] and r.get("readmit_incarnation") == 2
        hb = srv._dispatch({"op": "heartbeat", "executor_id": 1,
                            "incarnation": 0})
        assert hb.get("fenced") and hb["stop"]
        assert "readmit_incarnation" not in hb
        assert srv.cluster_metrics()["counters"].get("probe.alive") == 7
    finally:
        srv.stop()


def test_silent_probation_reaps_into_ordinary_death(monkeypatch):
    from tensorflowonspark_torch import coordinator as coord_mod

    monkeypatch.setenv("TOS_COLLECTIVE_PROBATION_SECS", "600")
    monkeypatch.setattr(coord_mod, "_EVICT_CONFIRM_SECS", 0.0)
    srv = CoordinatorServer(3)
    try:
        _form_three(srv)
        for voter, blamed in ((2, 1), (0, 1)):
            srv._dispatch({"op": "suspect", "group": "train",
                           "suspect": blamed, "wait_secs": 3.0,
                           "executor_id": voter, "incarnation": 0})
        assert 1 in srv.evicted_members()
        srv.drain_collective_events()
        srv._dispatch({"op": "heartbeat", "executor_id": 1,
                       "incarnation": 0})
        assert srv.reap_silent_probation(10.0) == []
        time.sleep(0.25)
        assert srv.reap_silent_probation(0.2) == [1]
        assert srv.evicted_members() == {}
        assert srv.registered_incarnation(1)[0] == 2
        assert [e["kind"] for e in srv.drain_collective_events()] == \
            ["probation_death"]
        r = srv._dispatch({"op": "register", "meta": {"host": "h1c"},
                           "replace": 1})
        assert r["ok"] and r["incarnation"] == 2
    finally:
        srv.stop()


def test_resolve_blame_cycles_and_chains_off_ring():
    resolve = CoordinatorServer._resolve_blame_locked
    reports = {1: {2: 0.0}, 2: {0: 0.0}}
    assert resolve(reports, 1) == 1
    assert resolve(reports, 2) == 1
    reports = {2: {0: 0.0}, 1: {2: 0.0}, 0: {1: 0.0}}
    assert all(resolve(reports, b) is None for b in (0, 1, 2))
    reports = {1: {0: 0.0}, 2: {0: 0.0}, 3: {0: 0.0}, 0: {1: 0.0, 2: 0.0,
                                                          3: 0.0}}
    assert all(resolve(reports, b) is None for b in (0, 1, 2, 3))
    reports = {2: {0: 0.0}, 0: {1: 0.0, 3: 0.0}}
    assert resolve(reports, 2) == 2
    assert resolve(reports, 0) == 2


def test_node_collective_group_needs_a_data_port():
    """``ctx.collective_group`` rides the data-plane wire: a node whose
    registration carries no data_port is refused with that reason."""
    from tensorflowonspark_torch.node import NodeContext

    ctx = NodeContext.__new__(NodeContext)
    ctx.cluster_info = [{"executor_id": 0, "host": "h"}]
    ctx.executor_id = 0
    with pytest.raises(RuntimeError, match="data_port"):
        ctx.collective_group()


def test_world1_group_trees_keep_leaf_kinds():
    """A formed one-member group: ``all_reduce_tree`` gives new leaves of
    each input's kind and dtype (bf16 included) with the input's values,
    and ``sync_state`` of a ``TrainState`` comes back at the agreed step."""
    with torch_mapfuns.world1_group() as group:
        tree = {"a": torch.arange(5.0), "b": torch.ones(3, dtype=torch.bfloat16),
                "c": [np.arange(4, dtype=np.float32)], "n": None}
        out = group.all_reduce_tree(tree)
        assert out["a"] is not tree["a"] and out["a"].dtype == torch.float32
        torch.testing.assert_close(out["a"], tree["a"], rtol=0, atol=0)
        assert out["b"].dtype == torch.bfloat16 and out["b"].tolist() == [1.0] * 3
        assert isinstance(out["c"][0], np.ndarray) and out["n"] is None
        state = torch_mapfuns._linear_state(0.5, True, 0.1)
        synced, step = group.sync_state(state, 7)
        assert synced is state and step == 7


def test_sync_wide_deep_nodes_agree(tmp_path):
    """The monolithic wide-and-deep in ``mode="sync"`` on two node
    processes (``chip_smoke.py``'s sync phase at vocab 1009): the nodes end
    on bit-identical parameters, and every step's exchange carried the
    whole dense table gradient."""
    from tensorflowonspark_torch.data import PartitionedDataset
    from tensorflowonspark_torch.models import wide_deep

    config = {"model": "wide_deep", "vocab_size": 1009, "embed_dim": 4,
              "hidden": [8, 4], "bf16": False}
    rows = wide_deep.synthetic_criteo(64, seed=5)
    cluster = tcluster.run(
        torch_mapfuns.train_wide_deep_sync,
        {"model_config": config, "batch_size": 8, "device": "cpu"},
        num_executors=2, input_mode=tcluster.InputMode.STREAMING,
        log_dir=str(tmp_path), reservation_timeout=120.0)
    cluster.train(PartitionedDataset.from_iterable(rows, 4), mode="sync")
    cluster.shutdown(timeout=180.0)
    metas = [m.get("sync_wide_deep") for m in cluster.coordinator.cluster_info()]
    assert all(m is not None for m in metas), metas
    assert metas[0]["digest"] == metas[1]["digest"]
    params = 26 * 1009 * 5 + 13 + 1 + (26 * 4 + 13) * 8 + 8 + 8 * 4 + 4 + 4 + 1
    for m in metas:
        assert m["steps"] == 4 and m["finite"] and m["grad_device"] == "cpu"
        assert m["reduce_bytes"] == [4 * params] * 4
