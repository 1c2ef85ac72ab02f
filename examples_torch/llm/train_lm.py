"""LM training on one device — the single-device path of
``examples/llm/train_lm.py``, on PyTorch.

A decoder-only transformer trains on a synthetic Zipf token stream with
AdamW, then (``--generate N``) greedily decodes N tokens through the KV
cache.  On the card, attention runs hand-written kernels: the forward on
the Hopper ``wgmma`` kernel for ``--bf16``, and for f32 (the default) the
3xTF32 ``wgmma`` kernel, each at any head dim (d_model / n_heads; above
256, or 128 in f32, on the kernel's wide route); the backward up to a head
dim of 128 on the backward kernels (bf16, or 3xTF32 for f32), above it as
the recompute VJP through ``blockwise_attention``::

  # on the CPU, tiny:
  python examples_torch/llm/train_lm.py --device cpu --vocab-size 256 \\
      --d-model 64 --n-layers 2 --seq-len 64 --batch 4 --steps 5

  # on one card, bf16 or f32:
  python examples_torch/llm/train_lm.py --bf16 --seq-len 2048 --steps 20
  python examples_torch/llm/train_lm.py --seq-len 2048 --batch 2 --steps 5
  python examples_torch/llm/train_lm.py --bf16 --d-model 2048 --n-heads 4 \\
      --n-layers 2 --seq-len 2048 --batch 2 --steps 3   # head dim 512

MoE (``--n-experts``, top-2 routing over ``ep``) and the mesh
(``--tp/--sp/--ep``, ``dp`` taking the rest): ranks come from the
``torch.distributed`` environment (``torchrun``), one device per rank,
the model's parameters are cut by ``parallel.tp.shard_model`` and, with
``--sp > 1``, attention goes round the ``sp`` ring::

  # four ranks on the CPU (gloo), tp 2 x dp 2, then a MoE over ep 2 x sp 2:
  torchrun --nproc-per-node 4 examples_torch/llm/train_lm.py --device cpu \
      --tp 2 --vocab-size 256 --d-model 64 --n-layers 2 --seq-len 64 --batch 4
  torchrun --nproc-per-node 4 examples_torch/llm/train_lm.py --device cpu \
      --n-experts 4 --ep 2 --sp 2 --vocab-size 256 --d-model 64 --n-layers 2 \
      --seq-len 64 --batch 4
  # the MoE at the chip LM's width on one card:
  python examples_torch/llm/train_lm.py --bf16 --n-experts 8 --vocab-size 32000 \
      --d-model 1024 --n-layers 8 --seq-len 2048 --batch 8 --steps 10

Pipeline parallelism (``--pp N``, ``--pp-microbatches``): the blocks are
``N`` stages of ``n_layers / N`` each, trained by ``parallel.pp``'s 1F1B
schedule; the embedding and the loss head (final norm, lm_head and the
shifted cross-entropy, blockwise with ``--vocab-chunk``) stay outside the
pipe, and AdamW updates stages, head and embedding (``PipelinedLM``).  The
world is ``dp × pp`` ranks, ``pp`` innermost::

  torchrun --nproc-per-node 2 examples_torch/llm/train_lm.py --device cpu \
      --pp 2 --n-layers 4 --d-model 64 --n-heads 4 --seq-len 128 --batch 16 \
      --vocab-size 256

On one card every stage runs in this process (``chip_smoke.py``'s pp phase
drives ``PipelinedLM`` so).  ``--profile-dir DIR`` traces the timed steps
with ``torch.profiler`` (``profiling.profile_steps``) into a
TensorBoard/Chrome trace under DIR.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def synthetic_ids(batch, seq_len, vocab, seed=0):
    """Zipf-ish token stream: enough structure for the loss to move."""
    import numpy as np

    rng = np.random.RandomState(seed)
    base = rng.zipf(1.5, size=(batch, seq_len)).astype("int64")
    return (base % vocab).astype("int32")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--vocab-size", type=int, default=4096)
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--n-layers", type=int, default=4)
    p.add_argument("--n-heads", type=int, default=8)
    p.add_argument("--n-experts", type=int, default=0, help=">0 enables MoE over ep")
    p.add_argument("--seq-len", type=int, default=1024)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--ep", type=int, default=1)
    p.add_argument("--pp", type=int, default=1)
    p.add_argument("--pp-microbatches", type=int, default=4,
                   help="microbatches per step per dp row under --pp")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--vocab-chunk", type=int, default=0,
                   help=">0 fuses the lm_head into a blockwise cross-entropy "
                        "(ops/xent.py): never materializes [B,S,V] logits")
    p.add_argument("--remat", action="store_true",
                   help="recompute per-block activations in the backward "
                        "(torch.utils.checkpoint)")
    p.add_argument("--accum-steps", type=int, default=1,
                   help=">1 splits each batch into microbatches and "
                        "accumulates gradients before the optimizer update")
    p.add_argument("--generate", type=int, default=0,
                   help=">0 greedily decodes this many tokens after training "
                        "(KV-cache decode loop)")
    p.add_argument("--profile-dir", default="")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _init_world(device: str | None):
    """Join the ``torch.distributed`` world ``torchrun`` describes
    (``WORLD_SIZE`` > 1 in the environment): gloo on the CPU, NCCL on the
    card.  Returns whether this call formed it."""
    import torch.distributed as dist

    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return False
    dist.init_process_group("gloo" if device == "cpu" else "nccl")
    return True


def main(argv=None) -> dict:
    args = parse_args(argv)

    import torch
    import torch.distributed as dist

    from tensorflowonspark_torch import profiling
    from tensorflowonspark_torch.models import transformer as tfm
    from tensorflowonspark_torch.parallel import dp as dplib
    from tensorflowonspark_torch.parallel import mesh as meshlib
    from tensorflowonspark_torch.parallel import tp as tplib

    formed = _init_world(args.device)
    try:
        if args.pp > 1:
            return _train_pipelined(args)
        mesh = meshlib.make_mesh(args.device, dp=-1, tp=args.tp, sp=args.sp,
                                 ep=args.ep)
        dev = meshlib.device_of(mesh)
        lead = not dist.is_initialized() or dist.get_rank() == 0
        attn_impl = "ring" if args.sp > 1 else "auto"
        with torch.device(dev):
            model = tfm.Transformer(
                vocab_size=args.vocab_size, d_model=args.d_model,
                n_layers=args.n_layers, n_heads=args.n_heads,
                n_experts=args.n_experts, attn_impl=attn_impl, mesh=mesh,
                compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
                remat=args.remat)
        # the same seed on every rank, so every rank cuts the same weights
        model.init_weights(torch.Generator(device=dev).manual_seed(0))
        n_params = sum(p.numel() for p in model.parameters())
        tplib.shard_model(model, mesh)
        if lead:
            print(f"mesh: {meshlib.spec(mesh)} on {dev}")
            print(f"model: {n_params / 1e6:.2f}M params on {dev}, attn={attn_impl}")

        # every rank draws the global batch; shard_batch keeps its own rows
        ids = synthetic_ids(args.batch, args.seq_len, args.vocab_size)
        n_batch = meshlib.axis_size(mesh, "dp", "fsdp")
        if args.batch % n_batch:
            raise ValueError(f"--batch {args.batch} does not split over "
                             f"{n_batch} batch ranks")
        rows = args.batch // n_batch
        mine = ids[meshlib.axis_index(mesh, "dp", "fsdp") * rows:][:rows]
        optimizer = dplib.adamw(model.parameters(), args.lr)
        state = dplib.TrainState.create(model, optimizer)
        step = dplib.make_train_step(
            tfm.make_loss_fn(model, vocab_chunk=args.vocab_chunk), optimizer,
            accum_steps=args.accum_steps, mesh=mesh)
        batch = meshlib.shard_batch(mesh, {"input_ids": torch.from_numpy(mine)})

        state, metrics = step(state, batch)
        first = float(metrics["loss"])
        if lead:
            print(f"step 0: loss={first:.4f}")

        def one_step():
            nonlocal state
            state, m = step(state, batch)
            return m

        t0 = time.perf_counter()
        if args.profile_dir:
            # warmup already happened (the first step above), so the timed
            # window covers exactly args.steps executions.
            metrics = profiling.profile_steps(args.profile_dir, one_step,
                                              warmup=0, steps=args.steps)
        else:
            for _ in range(args.steps):
                metrics = one_step()
        loss = float(metrics["loss"])  # fetch = sync
        dt = time.perf_counter() - t0
        tokens = args.batch * args.seq_len * args.steps
        if lead:
            print(f"step {args.steps}: loss={loss:.4f} ({tokens / dt:,.0f} tokens/sec)")
            if args.n_experts:
                print(f"aux_loss={float(metrics['aux_loss']):.4f} "
                      f"router_z_loss={float(metrics['router_z_loss']):.4f}")

        out = None
        if args.generate:
            if args.sp > 1:
                raise ValueError("--generate decodes without the sp split; use --sp 1")
            model.eval()
            out = tfm.greedy_generate(model, ids[:1, :8], max_new_tokens=args.generate)
            if lead:
                print(f"generated: {out[0].tolist()}")
        return {"first_loss": first, "loss": loss, "tokens_per_sec": tokens / dt,
                "generated": out, "mesh": meshlib.spec(mesh),
                "aux_loss": float(metrics["aux_loss"]),
                "router_z_loss": float(metrics["router_z_loss"])}
    finally:
        if formed:
            dist.destroy_process_group()


class PipelinedLM:
    """The LM cut for ``parallel.pp`` (the JAX package's
    ``_train_pipelined``): this rank's stage of the blocks (every stage on
    a mesh whose ``pp`` axis is 1), the head and the embedding, as
    parameters of one AdamW.  ``loss_and_grads(ids)`` runs the 1F1B step
    on this rank's rows; the embedding's gradient comes from ``dx``
    (scattered by id, summed over ``dp``)."""

    def __init__(self, model, mesh, n_stages: int, n_microbatches: int,
                 vocab_chunk: int = 0, lr: float = 3e-4):
        import torch

        from tensorflowonspark_torch.models import transformer as tfm
        from tensorflowonspark_torch.parallel import dp as dplib
        from tensorflowonspark_torch.parallel import mesh as meshlib
        from tensorflowonspark_torch.parallel import pp as pplib

        self.mesh, self.m = mesh, n_microbatches
        self.dtype = model.compute_dtype
        self.stage_fn, stacked, head, emb = tfm.pipeline_parts(model, n_stages)
        stacked = meshlib.shard_tree(mesh, stacked, pplib.stage_shardings(mesh, stacked))
        dev = meshlib.device_of(mesh)

        def param(t):
            return torch.nn.Parameter(t.to(dev))

        self.stages = {k: param(v) for k, v in stacked.items()}
        self.head = {k: param(v) for k, v in head.items()}
        self.embed = param(emb)
        self.head_loss = tfm.pipeline_head_loss(model, vocab_chunk)
        self.optimizer = dplib.adamw([*self.stages.values(), *self.head.values(),
                                      self.embed], lr)

    def loss_and_grads(self, ids) -> tuple:
        """``(loss, {"stages", "head", "embed"} grads)`` for this rank's
        ``ids`` ``[B, S]``."""
        import torch
        import torch.nn.functional as F

        from tensorflowonspark_torch.parallel import mesh as meshlib
        from tensorflowonspark_torch.parallel import pp as pplib
        from tensorflowonspark_torch.parallel.tp import reduce_from

        ids = torch.as_tensor(ids, device=self.embed.device)
        x = F.embedding(ids, self.embed.detach()).to(self.dtype)
        loss, g_s, g_h, dx = pplib.pipeline_1f1b(
            self.stage_fn, self.stages, x, self.head_loss, mesh=self.mesh,
            n_microbatches=self.m, targets=ids, head_params=self.head,
            with_input_grad=True)
        g_e = torch.zeros(self.embed.shape, dtype=torch.float32, device=self.embed.device)
        g_e.index_add_(0, ids.reshape(-1).long(), dx.reshape(-1, dx.shape[-1]).float())
        g_e = reduce_from(g_e, meshlib.group(self.mesh, "dp"))
        return loss, {"stages": g_s, "head": g_h, "embed": g_e}

    def step(self, ids):
        """One AdamW step over stages, head and embedding; returns the loss."""
        loss, grads = self.loss_and_grads(ids)
        for p, g in zip([*self.stages.values(), *self.head.values(), self.embed],
                        [*grads["stages"].values(), *grads["head"].values(), grads["embed"]]):
            p.grad = g.to(p.dtype)
        self.optimizer.step()
        return loss


def _train_pipelined(args) -> dict:
    """1F1B pipeline-parallel LM training (``--pp N``) over a ``dp × pp``
    world, with the JAX example's refusals."""
    import torch
    import torch.distributed as dist

    from tensorflowonspark_torch import profiling
    from tensorflowonspark_torch.models import transformer as tfm
    from tensorflowonspark_torch.parallel import mesh as meshlib

    if args.tp != 1 or args.sp != 1 or args.ep != 1 or args.n_experts:
        raise SystemExit("--pp composes with dp only; set tp=sp=ep=1, n_experts=0")
    if args.generate or args.accum_steps != 1:
        raise SystemExit("--pp does not support --generate/--accum-steps "
                         "(decode uses the non-pp path; 1F1B already "
                         "microbatches every step)")
    if args.remat:
        raise SystemExit("--remat is implicit under --pp: 1F1B saves only "
                         "stage inputs and recomputes stage forwards")
    if args.n_layers % args.pp:
        raise SystemExit(f"--n-layers {args.n_layers} not divisible by --pp {args.pp}")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < args.pp:
        raise SystemExit(f"--pp {args.pp} needs {args.pp} ranks, have {world}")

    # dp over the remaining ranks: each dp row runs its own pipeline on its
    # rows, the grads averaged (pipeline_1f1b's data_axis path)
    mesh = meshlib.make_mesh(args.device, dp=-1, pp=args.pp)
    dev = meshlib.device_of(mesh)
    dp_size = meshlib.axis_size(mesh, "dp")
    m = args.pp_microbatches
    if args.batch % (dp_size * m):
        raise SystemExit(f"--batch {args.batch} not divisible by dp x "
                         f"--pp-microbatches = {dp_size} x {m}")
    lead = not dist.is_initialized() or dist.get_rank() == 0
    per_stage = args.n_layers // args.pp
    bubble = (args.pp - 1) / (m + args.pp - 1)
    if lead:
        print(f"mesh: dp={dp_size} pp={args.pp} on {dev}; {per_stage} blocks/stage, "
              f"{m} microbatches/row, bubble {bubble:.0%}")
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    with torch.device(dev):
        model = tfm.Transformer(vocab_size=args.vocab_size, d_model=args.d_model,
                                n_layers=args.n_layers, n_heads=args.n_heads,
                                compute_dtype=dtype)
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
    if lead:
        n_params = sum(p.numel() for p in model.parameters())
        print(f"model: {n_params / 1e6:.2f}M params, 1F1B pipeline")
    lm = PipelinedLM(model, mesh, args.pp, m, args.vocab_chunk, args.lr)
    ids = synthetic_ids(args.batch, args.seq_len, args.vocab_size)
    rows = args.batch // dp_size
    mine = torch.from_numpy(ids[meshlib.axis_index(mesh, "dp") * rows:][:rows])

    first = float(lm.step(mine))
    if lead:
        print(f"step 0: loss={first:.4f}")
    t0 = time.perf_counter()
    if args.profile_dir:
        loss = profiling.profile_steps(args.profile_dir, lambda: lm.step(mine),
                                       warmup=0, steps=args.steps)
    else:
        for _ in range(args.steps):
            loss = lm.step(mine)
    loss = float(loss)  # fetch = sync
    dt = time.perf_counter() - t0
    tokens = args.batch * args.seq_len * args.steps
    if lead:
        print(f"step {args.steps}: loss={loss:.4f} ({tokens / dt:,.0f} tokens/sec)")
    return {"first_loss": first, "loss": loss, "tokens_per_sec": tokens / dt,
            "mesh": meshlib.spec(mesh)}


if __name__ == "__main__":
    main()
