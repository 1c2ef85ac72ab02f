"""One rank of the gloo world that ``tests/test_torch_pp.py`` spawns (4 CPU
processes): it runs every case below in order, each on a mesh of its own
(``pp=4``, or ``dp=2, pp=2``), and writes what it computed to
``<dir>/rank<r>.npz`` (errors to ``<dir>/errors<r>.json``).  The stage
weights are made here from the numpy seeds of ``tests/test_parallel_pp.py``;
the transformer's come from ``<dir>/blocks.pt`` (converted by the test from
the JAX package's params).  Imports only the port.

    python tests/torch_pp_worker.py --rank R --world 4 --port P --dir D
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
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tensorflowonspark_torch.models import transformer as tfm  # noqa: E402
from tensorflowonspark_torch.parallel import mesh as meshlib  # noqa: E402
from tensorflowonspark_torch.parallel import pp as pplib  # noqa: E402
from tensorflowonspark_torch.parallel.tp import reduce_from  # noqa: E402

CASES: list = []
# the JAX tests' transformer: vocab 32, d_model 16, 4 heads, 2 stages x 2 blocks
BLOCKS = dict(vocab=32, d_model=16, n_heads=4, per_stage=2)


def case(fn):
    CASES.append(fn)
    return fn


def stage_fn(p, x):
    # jnp promotes a bf16 activation against f32 weights to f32
    return torch.tanh(x.to(p["w"].dtype) @ p["w"] + p["b"])


def make_stages(n_stages, d, seed=0):
    rng = np.random.RandomState(seed)
    return [{"w": torch.from_numpy((rng.randn(d, d) * 0.5).astype(np.float32)),
             "b": torch.from_numpy((rng.randn(d) * 0.1).astype(np.float32))}
            for _ in range(n_stages)]


def randn(seed, *shape):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32))


def rows_of(mesh, x):
    """This dp row's block of a global batch."""
    n = meshlib.axis_size(mesh, "dp")
    return x.chunk(n)[meshlib.axis_index(mesh, "dp")]


def mse(out, tgt):
    return ((out.float() - tgt) ** 2).mean()


class Env:
    def __init__(self, workdir: str):
        self.dir = workdir
        self.out: dict = {}

    def save(self, name: str, **arrays):
        for k, v in arrays.items():
            if isinstance(v, torch.Tensor):
                v = v.detach().float().cpu().numpy()
            self.out[f"{name}/{k}"] = np.asarray(v)


def mesh_pp4():
    return meshlib.make_mesh("cpu", pp=4)


def mesh_dp2_pp2():
    return meshlib.make_mesh("cpu", dp=2, pp=2)


def own(grads: dict) -> dict:
    """A rank's stage of stage-stacked grads (leading dim 1)."""
    return {k: v[0] for k, v in grads.items()}


@case
def gpipe_pp4(env):
    mesh = mesh_pp4()
    stacked = pplib.stack_stages(make_stages(4, 8))
    out = pplib.gpipe(stage_fn, stacked, randn(1, 16, 8), mesh=mesh, n_microbatches=4)
    env.save("gpipe_pp4", out=out)


@case
def gpipe_pp2_dp2(env):
    mesh = mesh_dp2_pp2()
    stacked = pplib.stack_stages(make_stages(2, 8))
    out = pplib.gpipe(stage_fn, stacked, rows_of(mesh, randn(1, 16, 8)), mesh=mesh,
                      n_microbatches=4)
    env.save("gpipe_pp2_dp2", out=out)


@case
def gpipe_microbatches(env):
    mesh = mesh_pp4()
    stacked = pplib.stack_stages(make_stages(4, 4))
    x = randn(2, 24, 4)
    for m in (2, 4, 8, 12):
        env.save("gpipe_microbatches", **{f"m{m}": pplib.gpipe(stage_fn, stacked, x,
                                                                mesh=mesh, n_microbatches=m)})


@case
def gpipe_placed(env):
    mesh = mesh_pp4()
    stacked = pplib.stack_stages(make_stages(4, 8))
    placed = meshlib.shard_tree(mesh, stacked, pplib.stage_shardings(mesh, stacked))
    out = pplib.gpipe(stage_fn, placed, randn(3, 8, 8), mesh=mesh, n_microbatches=2)
    env.save("gpipe_placed", out=out, local_shape=placed["w"].shape,
             local_w=placed["w"][0])


@case
def gpipe_descend(env):
    mesh = mesh_pp4()
    stacked = pplib.stack_stages(make_stages(4, 8))
    params = {k: torch.nn.Parameter(v) for k, v in meshlib.shard_tree(
        mesh, stacked, pplib.stage_shardings(mesh, stacked)).items()}
    opt = torch.optim.Adam(params.values(), lr=1e-2)
    x, y = randn(4, 16, 8), randn(5, 16, 8)
    losses = []
    for _ in range(10):
        opt.zero_grad()
        loss = mse(pplib.gpipe(stage_fn, params, x, mesh=mesh, n_microbatches=4), y)
        losses.append(loss.item())
        loss.backward()
        opt.step()
    env.save("gpipe_descend", losses=losses)


@case
def gpipe_grads(env):
    mesh = mesh_pp4()
    stacked = {k: v.requires_grad_() for k, v in
               pplib.stack_stages(make_stages(4, 8)).items()}
    out = pplib.gpipe(stage_fn, stacked, randn(4, 8, 8), mesh=mesh, n_microbatches=2)
    (out ** 2).sum().backward()
    idx = meshlib.axis_index(mesh, "pp")
    env.save("gpipe_grads", **{f"grad/{k}": v.grad[idx] for k, v in stacked.items()},
             others=sum(float(v.grad.abs().sum()) - float(v.grad[idx].abs().sum())
                        for v in stacked.values()))


@case
def f1b_pp4(env):
    mesh = mesh_pp4()
    stacked = pplib.stack_stages(make_stages(4, 8))
    x, y = randn(6, 12, 8), randn(7, 12, 8)
    for m in (6, 2):
        loss, grads = pplib.pipeline_1f1b(stage_fn, stacked, x, mse, mesh=mesh,
                                          n_microbatches=m, targets=y)
        env.save(f"f1b_pp4_m{m}", loss=loss, **{f"grad/{k}": v for k, v in own(grads).items()},
                 grad_lead=grads["w"].shape[0])


@case
def f1b_dp(env):
    mesh = mesh_dp2_pp2()
    stacked = pplib.stack_stages(make_stages(2, 8, seed=21))
    x, y = rows_of(mesh, randn(22, 16, 8)), rows_of(mesh, randn(23, 16, 8))
    loss, grads, dx = pplib.pipeline_1f1b(stage_fn, stacked, x, mse, mesh=mesh,
                                          n_microbatches=2, targets=y, with_input_grad=True)
    env.save("f1b_dp", loss=loss, dx=dx, **{f"grad/{k}": v for k, v in own(grads).items()})


@case
def f1b_bf16(env):
    mesh = mesh_pp4()
    stacked = pplib.stack_stages(make_stages(4, 8, seed=31))
    x16 = randn(32, 16, 8).to(torch.bfloat16)
    seen: set = set()
    exchange = pplib._exchange

    def recording(sends, recvs, grp):
        seen.update(str(t.dtype) for t, _ in sends)
        return exchange(sends, recvs, grp)

    pplib._exchange = recording
    try:
        loss, grads = pplib.pipeline_1f1b(stage_fn, stacked, x16, mse, mesh=mesh,
                                          n_microbatches=4, targets=randn(33, 16, 8))
    finally:
        pplib._exchange = exchange
    wires = [None] * dist.get_world_size()
    dist.all_gather_object(wires, sorted(seen))
    env.save("f1b_bf16", loss=loss, wires=sorted({d for w in wires for d in w}),
             **{f"grad/{k}": v for k, v in own(grads).items()})


@case
def f1b_no_targets(env):
    mesh = mesh_dp2_pp2()
    stacked = pplib.stack_stages(make_stages(2, 4, seed=3))
    # the JAX test's 4 microbatches of 2 rows over 8 rows: here each dp row
    # pipelines its 4 rows as 2 microbatches of 2
    loss, grads = pplib.pipeline_1f1b(stage_fn, stacked, rows_of(mesh, randn(8, 8, 4)),
                                      lambda out: (out ** 2).sum(), mesh=mesh,
                                      n_microbatches=2)
    env.save("f1b_no_targets", loss=loss, **{f"grad/{k}": v for k, v in own(grads).items()})


def block_stage():
    d, h = BLOCKS["d_model"], BLOCKS["n_heads"]
    blocks = [tfm.Block(d, h, d // h, 4 * d, attn_impl="auto", compute_dtype=torch.float32)
              for _ in range(BLOCKS["per_stage"])]
    return pplib.module_stage_fn(tfm.Stage(blocks))


def block_weights(env):
    return torch.load(os.path.join(env.dir, "blocks.pt"))


def head_logits(head, h):
    from torch.func import functional_call

    norm = tfm.RMSNorm(h.shape[-1])
    final = functional_call(norm, {"scale": head["final_norm.scale"]}, (h,))
    return F.linear(final, head["lm_head.weight"]).float()


@case
def f1b_blocks(env):
    mesh = mesh_dp2_pp2()
    w = block_weights(env)
    ids, tgt = rows_of(mesh, w["ids"]), rows_of(mesh, w["tgt"])
    h_in = F.embedding(ids.long(), w["embed"])

    def head_loss(h, tgt_mb):
        logp = torch.log_softmax(head_logits(w["head"], h), dim=-1)
        return -logp.gather(-1, tgt_mb[..., None].long()).mean()

    loss, grads = pplib.pipeline_1f1b(block_stage(), w["stacked"], h_in, head_loss,
                                      mesh=mesh, n_microbatches=2, targets=tgt)
    env.save("f1b_blocks", loss=loss, **{f"grad/{k}": v for k, v in own(grads).items()})


@case
def f1b_full_model(env):
    mesh = mesh_dp2_pp2()
    s, d, batch = 2, 6, 8
    rng = np.random.RandomState(12)
    stacked = pplib.stack_stages(make_stages(s, d, seed=12))
    head = {"w_out": torch.from_numpy((rng.randn(d, 3) * 0.5).astype(np.float32))}
    emb = torch.from_numpy((rng.randn(5, d) * 0.5).astype(np.float32))
    ids = torch.from_numpy(rng.randint(0, 5, (batch,)))
    tgt = torch.from_numpy(rng.randint(0, 3, (batch,)))
    ids, tgt = rows_of(mesh, ids), rows_of(mesh, tgt)

    def head_loss(hp, y, tgt_mb):
        logp = torch.log_softmax(y @ hp["w_out"], dim=-1)
        return -logp.gather(1, tgt_mb[:, None]).mean()

    loss, g_s, g_h, dx = pplib.pipeline_1f1b(
        stage_fn, stacked, emb[ids], head_loss, mesh=mesh, n_microbatches=2,
        targets=tgt, head_params=head, with_input_grad=True)
    g_e = torch.zeros_like(emb).index_add_(0, ids, dx)
    g_e = reduce_from(g_e, meshlib.group(mesh, "dp"))
    env.save("f1b_full_model", loss=loss, head=g_h["w_out"], emb=g_e,
             **{f"grad/{k}": v for k, v in own(g_s).items()})


@case
def gpipe_blocks(env):
    mesh = mesh_dp2_pp2()
    w = block_weights(env)
    stacked = {k: v.clone().requires_grad_() for k, v in w["stacked"].items()}
    ids = rows_of(mesh, w["ids"])
    h = pplib.gpipe(block_stage(), stacked, F.embedding(ids.long(), w["embed"]),
                    mesh=mesh, n_microbatches=2)
    logits = head_logits(w["head"], h)
    ((logits - rows_of(mesh, w["logit_tgt"])) ** 2).mean().backward()
    idx = meshlib.axis_index(mesh, "pp")
    env.save("gpipe_blocks", logits=logits,
             norms=[float(v.grad[idx].norm()) for v in stacked.values()])


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
