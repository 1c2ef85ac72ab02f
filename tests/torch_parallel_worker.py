"""One rank of the gloo world that ``tests/test_torch_parallel.py`` spawns
(4 CPU processes): it runs every case below in order, each on a mesh of
its own, and writes what it computed to ``<dir>/rank<r>.npz`` (errors to
``<dir>/errors<r>.json``).  Weights come from ``<dir>/<name>.pt`` (state
dicts the test converted from the JAX package's params); inputs are made
here from numpy seeds, as the test makes them for the JAX references.
Imports only the port.

    python tests/torch_parallel_worker.py --rank R --world 4 --port P --dir D
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tensorflowonspark_torch.models import transformer as tfm  # noqa: E402
from tensorflowonspark_torch.parallel import dp as dplib  # noqa: E402
from tensorflowonspark_torch.parallel import mesh as meshlib  # noqa: E402
from tensorflowonspark_torch.parallel import sp as splib  # noqa: E402
from tensorflowonspark_torch.parallel import tp as tplib  # noqa: E402

# the JAX tests' tiny LM (tests/test_transformer_parallel.py), f32
CFG = dict(model="transformer", vocab_size=64, d_model=32, n_layers=2,
           n_heads=4, bf16=False)
CASES: list = []


def case(fn):
    CASES.append(fn)
    return fn


def ids16():
    return np.random.RandomState(0).randint(0, 64, (4, 16)).astype(np.int32)


def ids32():
    return np.random.RandomState(1).randint(0, 64, (4, 32)).astype(np.int32)


def global_qkv(b=4, s=64, h=4, d=16, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, s, h, d).astype(np.float32) for _ in range(3))


class Env:
    def __init__(self, workdir: str):
        self.dir = workdir
        self.out: dict = {}

    def model(self, weights: str, mesh, **over):
        model = _build({**CFG, **over}, mesh)
        model.load_state_dict(torch.load(os.path.join(self.dir, f"{weights}.pt")))
        dplib.replicate(model, mesh)
        return tplib.shard_model(model, mesh)

    def save(self, name: str, **arrays):
        for k, v in arrays.items():
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            self.out[f"{name}/{k}"] = np.asarray(v)


def _build(cfg, mesh):
    return tfm.Transformer(
        vocab_size=cfg["vocab_size"], d_model=cfg["d_model"],
        n_layers=cfg["n_layers"], n_heads=cfg["n_heads"],
        n_experts=cfg.get("n_experts", 0), attn_impl=cfg.get("attn_impl", "auto"),
        mesh=mesh, compute_dtype=torch.float32)


def rows_of(mesh, x):
    """This rank's rows of a global batch (its index over dp × fsdp)."""
    n = meshlib.axis_size(mesh, "dp", "fsdp")
    per = x.shape[0] // n
    return x[meshlib.axis_index(mesh, "dp", "fsdp") * per:][:per]


def seq_of(mesh, x, dim=1):
    n = meshlib.axis_size(mesh, "sp")
    return np.array_split(x, n, axis=dim)[meshlib.axis_index(mesh, "sp")]


def one_step_grads(env, model, mesh, batch):
    """Loss, metrics and the whole gradients of one backward, synced over
    the mesh as ``make_train_step`` syncs them."""
    loss_fn = tfm.make_loss_fn(model)
    named = [(n, p) for n, p in model.named_parameters()]
    total, metrics = loss_fn(model, batch)
    total.backward()
    dplib._mesh_grad_sync(model, mesh, named)
    metrics = dplib._mesh_metrics({"loss": total, **metrics}, mesh)
    grads = tplib.full_parameters(model, mesh, grads=True)
    return metrics, grads


# -- tests/test_transformer_parallel.py -------------------------------------

@case
def tp2_dp2(env):
    mesh = meshlib.make_mesh("cpu", dp=2, tp=2)
    model = env.model("dense", mesh)
    with torch.no_grad():
        env.save("tp2_dp2", logits=model(torch.from_numpy(rows_of(mesh, ids16()))),
                 q_rows=model.blocks[0].attn.q_proj.weight.shape[0])


@case
def tp2_fsdp2(env):
    mesh = meshlib.make_mesh("cpu", fsdp=2, tp=2)
    model = env.model("dense", mesh)
    ids = torch.from_numpy(rows_of(mesh, ids16()))
    with torch.no_grad():
        logits = model(ids)
    local = {tplib.param_name(n): tuple(p.shape) for n, p in model.named_parameters()}
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    step = dplib.make_train_step(tfm.make_loss_fn(model), opt, mesh=mesh)
    state, metrics = step(dplib.TrainState.create(model, opt), {"input_ids": ids})
    params = tplib.full_parameters(model, mesh)
    env.save("tp2_fsdp2", logits=logits, loss=metrics["loss"],
             emb_local_shape=np.asarray(local["embed.weight"]),
             **{f"param/{k}": v for k, v in params.items()})



def decode_ids():
    """The prompt source of ``test_tp_sharded_decode_matches_unsharded``."""
    return np.random.RandomState(0).randint(0, 32, (2, 8)).astype(np.int32)


@case
def tp4_decode(env):
    """Model-parallel serving: ``greedy_generate`` on the JAX test's LM
    (vocab 32, d_model 16, 2 layers, 4 heads, f32) with its heads, MLP
    and vocab split over tp=4, beside the same model unsharded."""
    over = dict(vocab_size=32, d_model=16, attn_impl="xla")
    prompt = decode_ids()[:, :5]
    mesh = meshlib.make_mesh("cpu", tp=4)
    sharded = env.model("decode", mesh, **over)
    whole = _build({**CFG, **over}, None)
    whole.load_state_dict(torch.load(os.path.join(env.dir, "decode.pt")))
    env.save("tp4_decode",
             tokens=tfm.greedy_generate(sharded, prompt, max_new_tokens=4),
             unsharded=tfm.greedy_generate(whole, prompt, max_new_tokens=4),
             q_rows=sharded.blocks[0].attn.q_proj.weight.shape[0])


@case
def ring_model_sp4(env):
    mesh = meshlib.make_mesh("cpu", sp=4)
    model = env.model("dense", mesh, attn_impl="ring")
    ids = torch.from_numpy(ids32())
    with torch.no_grad():
        logits = model(ids)
    metrics, grads = one_step_grads(env, model, mesh, {"input_ids": ids})
    env.save("ring_model_sp4", logits=logits, loss=metrics["loss"],
             **{f"grad/{k}": v for k, v in grads.items()})


def mask32():
    """A ragged loss mask for ``ids32``: row r keeps its first 32 - 5r tokens."""
    return (np.arange(32)[None, :] < 32 - 5 * np.arange(4)[:, None]).astype(np.float32)


@case
def ring_model_sp4_masked(env):
    mesh = meshlib.make_mesh("cpu", sp=4)
    model = env.model("dense", mesh, attn_impl="ring")
    batch = {"input_ids": torch.from_numpy(ids32()), "loss_mask": mask32()}
    metrics, grads = one_step_grads(env, model, mesh, batch)
    env.save("ring_model_sp4_masked", loss=metrics["loss"],
             **{f"grad/{k}": v for k, v in grads.items()})


@case
def ulysses_model_sp4(env):
    mesh = meshlib.make_mesh("cpu", sp=4)
    model = env.model("dense", mesh, attn_impl="ulysses")
    with torch.no_grad():
        env.save("ulysses_model_sp4", logits=model(torch.from_numpy(ids32())))


@case
def moe_ep4(env):
    mesh = meshlib.make_mesh("cpu", ep=4)
    model = env.model("moe", mesh, n_experts=4)
    ids = torch.from_numpy(ids16())
    with torch.no_grad():
        logits = model(ids)
    metrics, grads = one_step_grads(env, model, mesh, {"input_ids": ids})
    env.save("moe_ep4", logits=logits, experts_local=model.blocks[0].moe.experts_up.shape[0],
             **{f"metric/{k}": v for k, v in metrics.items()},
             **{f"grad/{k}": v for k, v in grads.items()})


@case
def moe_sp2_ep2(env):
    mesh = meshlib.make_mesh("cpu", sp=2, ep=2)
    model = env.model("moe", mesh, n_experts=4, attn_impl="ring")
    ids = torch.from_numpy(ids16())
    metrics, grads = one_step_grads(env, model, mesh, {"input_ids": ids})
    env.save("moe_sp2_ep2", **{f"metric/{k}": v for k, v in metrics.items()},
             **{f"grad/{k}": v for k, v in grads.items()})


@case
def moe_dp2_sp2(env):
    mesh = meshlib.make_mesh("cpu", dp=2, sp=2)
    model = env.model("moe", mesh, n_experts=4, attn_impl="ring")
    ids = torch.from_numpy(rows_of(mesh, ids16()))
    with torch.no_grad():
        logits = model(ids)
    metrics, grads = one_step_grads(env, model, mesh, {"input_ids": ids})
    env.save("moe_dp2_sp2", logits=logits, **{f"metric/{k}": v for k, v in metrics.items()},
             **{f"grad/{k}": v for k, v in grads.items()})


def _descend(env, name, weights, **over):
    mesh = meshlib.make_mesh("cpu", dp=-1)
    model = env.model(weights, mesh, **over)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    step = dplib.make_train_step(tfm.make_loss_fn(model), opt, mesh=mesh)
    state = dplib.TrainState.create(model, opt)
    batch = meshlib.shard_batch(mesh, {"input_ids": rows_of(mesh, np.tile(ids16(), (2, 1)))})
    losses = []
    for _ in range(5):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
    env.save(name, losses=np.asarray(losses), steps=state.step)


@case
def train_descends_dp4(env):
    _descend(env, "train_descends_dp4", "dense")


@case
def moe_train_descends_dp4(env):
    _descend(env, "moe_train_descends_dp4", "moe", n_experts=4)


# -- tests/test_parallel_sp.py, at sp=4 --------------------------------------

def _sp_attention(env, name, impl, causal, b=4, s=64, h=4, d=16, via_mesh=False):
    mesh = meshlib.make_mesh("cpu", sp=4)
    q, k, v = (torch.from_numpy(seq_of(mesh, x)) for x in global_qkv(b, s, h, d))
    if via_mesh:
        out = splib.sequence_parallel_attention(mesh, q, k, v, causal=causal, impl=impl)
    elif impl == "ring":
        out = splib.ring_attention(q, k, v, meshlib.group(mesh, "sp"), causal=causal)
    else:
        out = splib.ulysses_attention(q, k, v, meshlib.group(mesh, "sp"), causal=causal)
    env.save(name, out=tplib.gather_from(out, 1, meshlib.group(mesh, "sp")))


@case
def ring_attention(env):
    for causal in (True, False):
        _sp_attention(env, f"ring_attention_{causal}", "ring", causal)


@case
def ulysses_attention(env):
    for causal in (True, False):
        _sp_attention(env, f"ulysses_attention_{causal}", "ulysses", causal)


@case
def ring_attention_sp4_b2(env):
    _sp_attention(env, "ring_attention_sp4_b2", "ring", True, b=2)


@case
def ring_attention_via_mesh(env):
    _sp_attention(env, "ring_attention_via_mesh", "ring", True, via_mesh=True)


@case
def ring_attention_grads(env):
    mesh = meshlib.make_mesh("cpu", sp=4)
    grp = meshlib.group(mesh, "sp")
    q, k, v = (torch.from_numpy(seq_of(mesh, x)).requires_grad_()
               for x in global_qkv(b=2, s=32, h=2, d=8))
    o = splib.ring_attention(q, k, v, grp, causal=True)
    # the global loss is the sum over ranks of each rank's own part
    (o.float() ** 2).sum().backward()
    env.save("ring_attention_grads",
             **{n: tplib.gather_from(x.grad, 1, grp) for n, x in zip("qkv", (q, k, v))})


# -- tests/test_parallel_dp.py, at dp=4 --------------------------------------

@case
def batch_sharded_dp4(env):
    from tensorflowonspark_torch.feeding import DataFeed, FeedQueues
    from tensorflowonspark_torch.marker import EndOfFeed, EndPartition

    mesh = meshlib.make_mesh("cpu", dp=4)
    rank = meshlib.axis_index(mesh, "dp")
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    queues = FeedQueues()
    q = queues.get_queue("input")
    for row in x[rank * 4:(rank + 1) * 4]:  # this rank's partition
        q.put(row)
    q.put(EndPartition())
    q.put(EndOfFeed())
    feed = DataFeed(queues, train_mode=True, poll_interval=0.05)
    got = list(dplib.make_batch_iterator(feed, 4, lambda rows: {"x": np.stack(rows)},
                                         mesh=mesh, lockstep=False))
    batch, n = got[0]
    env.save("batch_sharded_dp4", local=batch["x"], n=n, batches=len(got),
             whole=tplib.gather_from(batch["x"], 0, meshlib.group(mesh, "dp")))


@case
def linreg_dp4(env):
    mesh = meshlib.make_mesh("cpu", dp=4)

    class LinReg(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(4))
            self.b = torch.nn.Parameter(torch.zeros(()))

    def loss_fn(m, batch):
        pred = batch["x"] @ m.w + m.b
        return ((pred - batch["y"]) ** 2).mean(), {}

    model = dplib.replicate(LinReg(), mesh)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    step = dplib.make_train_step(loss_fn, opt, mesh=mesh)
    x = np.random.RandomState(1).randn(16, 4).astype(np.float32)
    y = np.ones((16,), np.float32)
    batch = meshlib.shard_batch(mesh, {"x": rows_of(mesh, x), "y": rows_of(mesh, y)})
    state, metrics = step(dplib.TrainState.create(model, opt), batch)
    env.save("linreg_dp4", w=model.w, b=model.b, loss=metrics["loss"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--dir", required=True)
    args = ap.parse_args(argv)
    torch.manual_seed(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{args.port}",
                            rank=args.rank, world_size=args.world,
                            timeout=datetime.timedelta(seconds=90))
    env = Env(args.dir)
    errors = {}
    try:
        for fn in CASES:
            try:
                fn(env)
            except Exception:  # noqa: BLE001 - reported per case to the test
                errors[fn.__name__] = traceback.format_exc()
    finally:
        np.savez(os.path.join(args.dir, f"rank{args.rank}.npz"), **env.out)
        with open(os.path.join(args.dir, f"errors{args.rank}.json"), "w") as f:
            json.dump(errors, f)
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
