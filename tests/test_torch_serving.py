"""Port serving replica: a bundle written by the JAX package's
``export_bundle``, served by the port's ``serving_loop`` over an in-process
``DataFeed`` on the CPU, against the JAX ``build_apply`` logits; the bundle
format in both directions; and the port's import hygiene."""

import ast
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tensorflowonspark_torch import checkpoint as tckpt
from tensorflowonspark_torch import telemetry as ttel
from tensorflowonspark_torch.feeding import DataFeed, FeedQueues
from tensorflowonspark_torch.inference import bundle_inference_loop
from tensorflowonspark_torch.marker import EndOfFeed, EndPartition, ResultChunk
from tensorflowonspark_torch.serving.batcher import CTL_KEY
from tensorflowonspark_torch.serving.loop import serving_loop
from tensorflowonspark_tpu import checkpoint as jckpt
from tensorflowonspark_tpu.models import registry as jreg
from tensorflowonspark_tpu.models import transformer as jtfm

REPO = Path(__file__).resolve().parent.parent
CFG = {"model": "transformer", "vocab_size": 64, "d_model": 32, "n_layers": 2,
       "n_heads": 4, "bf16": False, "attn_impl": "pallas_interpret"}
SEQ = 24


class _Ctx:
    """The slice of the node context a map_fun uses: its feed and metrics
    (and its place in a one-replica world)."""

    executor_id, num_executors = 0, 1

    def __init__(self, queues):
        self.queues = queues
        self.metrics = ttel.get_registry()

    def get_data_feed(self, train_mode=True):
        return DataFeed(self.queues, train_mode=train_mode, poll_interval=0.05)


def _params(cfg=CFG, seed=0):
    model = jtfm.build_transformer(cfg)
    ids = np.zeros((1, SEQ), np.int32)
    return jax.tree.map(np.asarray,
                        model.init(jax.random.PRNGKey(seed), ids)["params"])


def _rows(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 64, (SEQ,)).astype(np.int32) for _ in range(n)]


def _run(loop, args, items):
    """Feed ``items`` then EndOfFeed; run ``loop`` to the end; return the
    flattened output queue."""
    queues = FeedQueues(capacity=1024)
    q = queues.get_queue("input")
    for it in items:
        q.put(it)
    q.put(EndOfFeed())
    errors = []

    def target():
        try:
            loop(args, _Ctx(queues))
        except BaseException as e:  # surfaced below
            errors.append(e)

    t = threading.Thread(target=target)
    t.start()
    t.join(120)
    assert not t.is_alive(), "map_fun did not finish"
    if errors:
        raise errors[0]
    out, oq = [], queues.get_queue("output")
    while not oq.empty():
        got = oq.get()
        out.extend(got.items if isinstance(got, ResultChunk) else [got])
    return out


def test_serving_loop_serves_jax_bundle(tmp_path):
    export = str(tmp_path / "bundle")
    params = _params()
    jckpt.export_bundle(export, params, CFG)
    japply = jreg.build_apply(CFG)
    batches = [_rows(4, 1), _rows(4, 2), _rows(3, 3)]  # last one is partial
    items = []
    for rows in batches:
        items += rows + [EndPartition()]
    items += [{CTL_KEY: "ping", "nonce": 7}, EndPartition(),
              {CTL_KEY: "reload"}, EndPartition(),
              {CTL_KEY: "bogus"}, EndPartition(),
              _rows(1, 4)[0], EndPartition()]  # served after the reload
    tckpt.invalidate_bundle()
    nodes_before = ttel.counter("serve.node_rows").value()
    out = _run(serving_loop, {"export_dir": export, "max_batch": 4,
                              "device": "cpu"}, items)
    assert len(out) == 4 + 4 + 3 + 3 + 1  # one result per row and per ctl
    served = out[:11] + out[14:]
    acks = out[11:14]
    assert acks[0] == {CTL_KEY: "pong", "nonce": 7}
    assert acks[1][CTL_KEY] == "reloaded" and acks[1]["export_dir"] == export
    assert acks[1]["signature"] == tckpt.bundle_signature(export)
    assert acks[2] == {CTL_KEY: "unknown:bogus"}
    want_rows = [r for rows in batches for r in rows] + _rows(1, 4)
    for rows_in_batch, start in ((batches[0], 0), (batches[1], 4), (batches[2], 8)):
        padded = rows_in_batch + [rows_in_batch[-1]] * (4 - len(rows_in_batch))
        ref = np.asarray(japply(params, np.stack(padded)))[:len(rows_in_batch)]
        got = np.stack(served[start:start + len(rows_in_batch)])
        assert got.shape == (len(rows_in_batch), SEQ, 64)
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    ref = np.asarray(japply(params, np.stack(want_rows[-1:] * 4)))[0]
    np.testing.assert_allclose(served[-1], ref, atol=1e-4, rtol=1e-4)
    assert ttel.counter("serve.node_rows").value() - nodes_before == 12


def test_bundle_inference_loop_serves_jax_bundle(tmp_path):
    export = str(tmp_path / "bundle")
    params = _params(seed=1)
    jckpt.export_bundle(export, params, CFG)
    rows = _rows(3, 5)
    ref = np.asarray(jreg.build_apply(CFG)(params, np.stack(rows + rows[-1:])))[:3]
    tckpt.invalidate_bundle()
    out = _run(bundle_inference_loop, {"export_dir": export, "batch_size": 4,
                                       "device": "cpu"}, rows + [EndPartition()])
    np.testing.assert_allclose(np.stack(out), ref, atol=1e-4, rtol=1e-4)


def test_serving_loop_refuses_sharded_embedding_bundle(tmp_path):
    """A sharded-embedding bundle is served from its table's shard files
    (the loop loads this replica's range of the table); one whose shard
    files are missing is refused before the loop takes a batch, as the JAX
    package's loop refuses it (a partial table must not serve silently)."""
    export = str(tmp_path / "bundle")
    block = {"name": "t", "total_rows": 12, "dim": 3, "step": 1}
    jckpt.export_bundle(export, _params(), {**CFG, "sharded_embedding": block})
    tckpt.invalidate_bundle()
    with pytest.raises(FileNotFoundError, match="covers only up to row 0"):
        _run(serving_loop, {"export_dir": export, "device": "cpu"}, [])


def test_bf16_bundle_reads_without_ml_dtypes(tmp_path):
    import ml_dtypes

    export = str(tmp_path / "bf16")
    rng = np.random.RandomState(0)
    w = rng.randn(5, 3).astype(np.float32)
    jckpt.export_bundle(export, {"a": {"w": w.astype(ml_dtypes.bfloat16)},
                                 "b": np.arange(4, dtype=np.int32)},
                        {"model": "x"})
    with open(os.path.join(export, "bundle.json")) as f:
        assert json.load(f)["_param_dtypes"] == {"a/w": "bfloat16"}
    params, config = tckpt.load_bundle(export)
    assert config == {"model": "x"}
    got = params["a"]["w"]
    assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.float().numpy(), w.astype(ml_dtypes.bfloat16).astype(np.float32))
    np.testing.assert_array_equal(params["b"], np.arange(4, dtype=np.int32))


def test_port_bundle_reads_in_jax_package(tmp_path):
    export = str(tmp_path / "port")
    w = torch.randn(4, 6, generator=torch.Generator().manual_seed(0))
    tckpt.export_bundle(export, {"x": {"w": w.bfloat16(), "f": w.numpy()}},
                        {"model": "y"})
    params, config = jckpt.load_bundle(export)
    assert config == {"model": "y"}
    np.testing.assert_array_equal(params["x"]["f"], w.numpy())
    np.testing.assert_array_equal(np.asarray(params["x"]["w"], np.float32),
                                  w.bfloat16().float().numpy())
    back, _ = tckpt.load_bundle(export)
    assert torch.equal(back["x"]["w"], w.bfloat16())


def test_orbax_bundle_layout_raises_clearly(tmp_path):
    """A bundle with neither ``params.npz`` nor an orbax checkpoint at
    ``params/`` (here an empty ``params/``) raises ``FileNotFoundError``
    naming both; the orbax layout itself is read (tests/test_torch_orbax.py)."""
    export = tmp_path / "orbax"
    (export / "params").mkdir(parents=True)
    (export / "bundle.json").write_text(json.dumps({"model": "x"}))
    with pytest.raises(FileNotFoundError, match="neither params.npz nor an orbax"):
        tckpt.load_bundle(str(export))


# -- hygiene: the port imports no JAX and nothing of the JAX package ----------

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ml_dtypes",
             "tensorflowonspark_tpu", "zstandard", "tensorstore")


def _port_sources():
    files = sorted((REPO / "tensorflowonspark_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_port_sources_import_no_jax():
    bad = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [f"{path.relative_to(REPO)}:{node.lineno} {n}"
                    for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_port_import_loads_no_jax_in_a_fresh_process():
    code = ("import sys, importlib, pkgutil, tensorflowonspark_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
