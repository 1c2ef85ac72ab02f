"""LM training on one device — the single-device path of
``examples/llm/train_lm.py``, on PyTorch.

A decoder-only transformer trains on a synthetic Zipf token stream with
AdamW, then (``--generate N``) greedily decodes N tokens through the KV
cache.  On the card, attention runs a hand-written kernel forward with its
recompute backward: the Hopper ``wgmma`` kernel for ``--bf16``, and for
f32 (the default) the 3xTF32 ``wgmma`` kernel, each at any head dim
(d_model / n_heads; above 256, or 128 in f32, on the kernel's wide
route)::

  # on the CPU, tiny:
  python examples_torch/llm/train_lm.py --device cpu --vocab-size 256 \\
      --d-model 64 --n-layers 2 --seq-len 64 --batch 4 --steps 5

  # on one card, bf16 or f32:
  python examples_torch/llm/train_lm.py --bf16 --seq-len 2048 --steps 20
  python examples_torch/llm/train_lm.py --seq-len 2048 --batch 2 --steps 5
  python examples_torch/llm/train_lm.py --bf16 --d-model 2048 --n-heads 4 \\
      --n-layers 2 --seq-len 2048 --batch 2 --steps 3   # head dim 512

Mesh parallelism (``--tp/--sp/--ep/--pp``), MoE (``--n-experts``) and
``--profile-dir`` are not ported yet and raise.
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


def main(argv=None) -> dict:
    args = parse_args(argv)
    for flag in ("tp", "sp", "ep", "pp"):
        if getattr(args, flag) > 1:
            raise NotImplementedError(
                f"--{flag} > 1 is not ported yet: ROADMAP.md queue 1 (e), "
                "MoE and parallel/*")
    if args.n_experts:
        raise NotImplementedError(
            "--n-experts (MoE) is not ported yet: ROADMAP.md queue 1 (e), "
            "MoE and parallel/*")
    if args.profile_dir:
        raise NotImplementedError(
            "--profile-dir is not ported yet: profiling.py is ROADMAP.md "
            "queue 1 (f)")

    import torch

    from tensorflowonspark_torch.gpu_info import default_device
    from tensorflowonspark_torch.models import transformer as tfm
    from tensorflowonspark_torch.parallel import dp as dplib

    dev = default_device(args.device)
    with torch.device(dev):
        model = tfm.Transformer(
            vocab_size=args.vocab_size, d_model=args.d_model,
            n_layers=args.n_layers, n_heads=args.n_heads, attn_impl="auto",
            compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
            remat=args.remat)
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params / 1e6:.2f}M params on {dev}")

    ids = synthetic_ids(args.batch, args.seq_len, args.vocab_size)
    optimizer = dplib.adamw(model.parameters(), args.lr)
    state = dplib.TrainState.create(model, optimizer)
    step = dplib.make_train_step(
        tfm.make_loss_fn(model, vocab_chunk=args.vocab_chunk), optimizer,
        accum_steps=args.accum_steps)
    batch = {"input_ids": torch.from_numpy(ids).to(dev)}

    state, metrics = step(state, batch)
    first = float(metrics["loss"])
    print(f"step 0: loss={first:.4f}")

    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, metrics = step(state, batch)
    loss = float(metrics["loss"])  # fetch = sync
    dt = time.perf_counter() - t0
    tokens = args.batch * args.seq_len * args.steps
    print(f"step {args.steps}: loss={loss:.4f} ({tokens / dt:,.0f} tokens/sec)")

    out = None
    if args.generate:
        model.eval()
        out = tfm.greedy_generate(model, ids[:1, :8], max_new_tokens=args.generate)
        print(f"generated: {out[0].tolist()}")
    return {"first_loss": first, "loss": loss, "tokens_per_sec": tokens / dt,
            "generated": out}


if __name__ == "__main__":
    main()
