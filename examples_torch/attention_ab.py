"""Time the attention kernels and the f32 LM train step of several
checkouts on one card, so that two versions are compared within one run:

    python examples_torch/attention_ab.py PARENT_DIR CHANGE_DIR CHANGE_DIR PARENT_DIR

Each directory is a checkout of the repo (for example ``git archive`` of a
commit, unpacked).  For each, in the order given, two child processes run
on the card:

- one imports that checkout's ``tensorflowonspark_torch``, builds its
  kernels, and times ``flash_attn_fwd_cuda`` at ``CASES`` (50 calls back
  to back between two CUDA events behind a spin kernel, median of 5
  windows, and the host's ms to queue one call: ``chip_smoke.time_ms`` of
  this script's checkout), each held against the plain version
  (``chunk_attention``) at ``chip_smoke.py``'s gates and beside
  ``F.scaled_dot_product_attention`` on the same inputs (the yardstick,
  with the backend that answered), and reports the registers and spills
  (ptxas) and HGMMA/UTMALDG counts (SASS) of its kernel instantiations
  (the forward's bf16/fp16 and 3xTF32, and the backward's); where the
  checkout's ``_launch`` takes ``wide``, it also times the wide route on
  the cases of ``WIDE_ONE_SLICE`` (bf16 D=256, f32 D=128), held against
  the plain version, beside the dedicated configuration of that head dim;
  and it times the backward at ``BWD_CASES`` the same way: what
  ``FlashAttention.backward`` runs on the card in that checkout
  (``_bwd_route``: the backward kernels, ``tos::flash_attn_bwd``, or the
  recompute VJP where that checkout has no kernel for the type), held
  against the plain version (``flash_attn_bwd_reference``) at
  ``chip_smoke.BWD_REL_TOL`` (f32 ``BWD_F32_REL_TOL``) and beside the
  library's backward (SDPA under autograd) on the same inputs;
- unless ``--steps 0``, one runs that checkout's
  ``examples_torch/llm/train_lm.py`` in f32 at the LM width of
  ``chip_smoke.py`` (vocab 32000, d_model 1024, 8 layers of 8 heads, B=2,
  S=2048) for ``--steps`` steps after one warm-up step, and reports ms per
  step from its tokens/s (host clock over the steps); then the same with
  its defaults (the example LM, f32: vocab 4096, d_model 256, 4 layers of
  8 heads of 32, B=8, S=1024).

Each directory's result is one line ``AB <dir> {json}``.  Needs one CUDA
card; exits non-zero if any child fails.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (name, B, Sq, Sk, H, D, causal, kv_offset, dtype name)
CASES = (("serving_shape", 4, 2048, 2048, 8, 128, True, 0, "bfloat16"),
         ("head_dim_64", 4, 2048, 2048, 16, 64, True, 0, "bfloat16"),
         ("f32_serving_shape", 4, 2048, 2048, 8, 128, True, 0, "float32"),
         ("bf16_d256", 4, 2048, 2048, 4, 256, True, 0, "bfloat16"),
         # the head-dim-256 f32 train step's shape
         ("f32_d256", 2, 2048, 2048, 4, 256, True, 0, "float32"),
         # the wide routes: the long causal shapes of the head-dim-512 steps
         # and D=320, the ragged shape of chip_smoke.py's kernel phase, and
         # one-row decodes
         ("bf16_d512", 2, 2048, 2048, 2, 512, True, 0, "bfloat16"),
         ("f32_d512", 2, 2048, 2048, 2, 512, True, 0, "float32"),
         ("bf16_d320_causal", 2, 2048, 2048, 2, 320, True, 0, "bfloat16"),
         ("bf16_d320_ragged_noncausal", 2, 200, 330, 2, 320, False, 0, "bfloat16"),
         ("f32_d320", 2, 200, 330, 2, 320, True, 5, "float32"),
         ("bf16_d512_sq_1_causal_decode", 2, 1, 517, 2, 512, True, -516, "bfloat16"),
         ("f32_d256_sq_1_causal_decode", 2, 1, 517, 4, 256, True, -516, "float32"),
         # the head dims below the widest tiles: chip_smoke.py's D=32 and
         # D=96 shapes, D=192 at a long causal shape, and the LM examples'
         # attention (B=8 S=1024 H=8 D=32) in f32 and bf16
         ("bf16_d32", 4, 512, 512, 8, 32, True, 0, "bfloat16"),
         ("bf16_d96", 2, 300, 300, 8, 96, True, 0, "bfloat16"),
         ("bf16_d192", 4, 2048, 2048, 4, 192, True, 0, "bfloat16"),
         ("example_lm_d32_f32", 8, 1024, 1024, 8, 32, True, 0, "float32"),
         ("example_lm_d32_bf16", 8, 1024, 1024, 8, 32, True, 0, "bfloat16"),
         # head dims between two tiles, at long causal shapes: the tile's
         # k-steps of zero columns in Q K^T
         ("bf16_d48", 4, 2048, 2048, 16, 48, True, 0, "bfloat16"),
         ("bf16_d80", 4, 2048, 2048, 8, 80, True, 0, "bfloat16"),
         ("bf16_d160", 4, 2048, 2048, 4, 160, True, 0, "bfloat16"),
         ("bf16_d224", 4, 2048, 2048, 4, 224, True, 0, "bfloat16"))
# the backward's cases (name, B, S, H, D, dtype name; causal): the LM's
# training shape, the LM examples' attention (head dim 32) and head dim 64
# in bf16; the f32 LM step's shape and the example LM's in f32
BWD_CASES = (("bwd_train_shape", 8, 2048, 8, 128, "bfloat16"),
             ("bwd_example_lm_d32", 8, 1024, 8, 32, "bfloat16"),
             ("bwd_d64", 4, 2048, 16, 64, "bfloat16"),
             ("bwd_f32_train_shape", 2, 2048, 8, 128, "float32"),
             ("bwd_f32_example_lm_d32", 8, 1024, 8, 32, "float32"))
# cases also run on the wide route at one slice: whether it could take over
# from the dedicated configuration of the same head dim
WIDE_ONE_SLICE = ("bf16_d256", "f32_serving_shape")
TRAIN_BATCH, TRAIN_SEQ = 2, 2048
EXAMPLE_BATCH, EXAMPLE_SEQ = 8, 1024  # train_lm.py's defaults
TRAIN_ARGS = ("--vocab-size", "32000", "--d-model", "1024", "--n-layers", "8",
              "--n-heads", "8", "--seq-len", str(TRAIN_SEQ), "--batch", str(TRAIN_BATCH))


def _chip_smoke():
    """This checkout's ``chip_smoke`` module, loaded from its file (a
    checkout given on the command line has one of its own)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_kernels(tree: str, names: set[str] | None = None) -> dict:
    """In this process: ``tree``'s kernels timed at ``CASES`` and its
    backward kernels at ``BWD_CASES`` (those in ``names`` where it is
    given), and what ptxas and the SASS say of its kernel instantiations."""
    sys.path.insert(0, tree)
    import inspect

    import torch
    import torch.nn.functional as F

    from tensorflowonspark_torch.ops import attention as att
    from tensorflowonspark_torch.ops import cuda_build

    smoke = _chip_smoke()
    out: dict = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, b, sq, sk, h, d, causal, off, dtype_name in CASES:
        if names and name not in names:
            continue
        dtype = getattr(torch, dtype_name)
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
                   for s in (sq, sk, sk))
        tol = smoke.F32_TOL if dtype == torch.float32 else smoke.O_TOL
        o, lse = att.flash_attn_fwd_cuda(q, k, v, causal=causal, kv_offset=off)
        po, plse = att.chunk_attention(q, k, v, causal=causal, kv_offset=off)
        torch.testing.assert_close(o.float(), po.float(), **tol)
        ms, host_ms = smoke.time_ms(lambda: att.flash_attn_fwd_cuda(
            q, k, v, causal=causal, kv_offset=off))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa = dict(is_causal=causal)
        if causal and (sq != sk or off):  # SDPA's is_causal is top-left aligned
            sdpa = dict(attn_mask=att._causal_keep(sq, sk, off, q.device))
        library_ms = smoke.time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, **sdpa))[0]
        bound_ms, bound_by = smoke.attention_bound(
            b, sq, sk, h, d, causal, off, q.element_size(),
            smoke.PEAK_FLOPS[att._route(dtype, d)[0]])
        out[name] = {"ms": ms, "host_ms": host_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "bound_share": bound_ms / ms,
                     "library_ms": library_ms,
                     "library_backend": smoke.sdpa_choice(qt, kt, vt, **sdpa),
                     "max_abs_err": (o.float() - po.float()).abs().max().item(),
                     "lse_max_abs_err": (lse - plse).abs().max().item()}
        del o, lse, po, plse, qt, kt, vt
        if name in WIDE_ONE_SLICE and "wide" in inspect.signature(att._launch).parameters:
            route = att._route(q.dtype, d)[0]

            def wide():
                return att._launch(route, q, k, v, True, d ** -0.5, 0, wide=True)

            o, lse = wide()
            po, plse = att.chunk_attention(q, k, v, causal=True)
            torch.testing.assert_close(o.float(), po.float(), **tol)
            out[f"{name}_wide_one_slice"] = {
                "ms": smoke.time_ms(wide)[0],
                "max_abs_err": (o.float() - po.float()).abs().max().item(),
                "lse_max_abs_err": (lse - plse).abs().max().item()}
            del o, lse, po, plse
        del q, k, v
    for name, b, s, h, d, dtype_name in BWD_CASES:
        if names and name not in names:
            continue
        out[name] = time_backward(smoke, att, b, s, h, d, getattr(torch, dtype_name), gen)
    report, sass = {}, {}
    for lib in ("flash_attn_fwd", "flash_attn_fwd_tf32", "flash_attn_bwd",
                "flash_attn_bwd_tf32"):
        if not cuda_build.library_path(lib).exists():  # no case of its route ran
            continue
        report.update(smoke.ptxas_report(cuda_build.build_log(lib)))
        # HMMA beside the design's instructions: an mma.sync kernel (the f32
        # backward before its wgmma redesign) shows as such
        sass.update(smoke.sass_counts(cuda_build.library_path(lib),
                                      (*smoke.DESIGN_SASS, "HMMA")))
    out["build"] = {f"{lib}_D{d}_{dt}": {**regs, **sass.get((lib, d, dt), {})}
                    for (lib, d, dt), regs in sorted(report.items(), key=str)}
    return out


def time_backward(smoke, att, b, s, h, d, dtype, gen) -> dict:
    """The backward of ``att`` (one checkout's ``ops.attention``) at one
    causal shape of ``dtype``, as its ``FlashAttention.backward`` runs it on
    the card (``_bwd_route``: the backward kernels, or the recompute VJP):
    held against the plain version and timed beside the library's backward
    on the same inputs."""
    import torch
    import torch.nn.functional as F

    q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    cot = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    _, lse = att.flash_attn_fwd_cuda(q, k, v, causal=True)
    route = att._bwd_route(dtype, d)[0]
    if route == "recompute":
        def backward():
            return att._recompute_bwd(q, k, v, cot, None, True, None, 0)
    else:
        def backward():
            return torch.ops.tos.flash_attn_bwd(q, k, v, lse, cot, None, True, None, 0)
    got = backward()
    want = att.flash_attn_bwd_reference(q, k, v, lse, cot, None, causal=True)
    rel = {n: smoke.rel_l2(x, y) for n, x, y in zip(("dq", "dk", "dv"), got, want)}
    f32 = dtype == torch.float32
    if max(rel.values()) > (smoke.BWD_F32_REL_TOL if f32 else smoke.BWD_REL_TOL):
        raise AssertionError(f"backward B={b} S={s} H={h} D={d} {dtype}: rel L2 {rel}")
    del got, want
    ms, host_ms = smoke.time_ms(backward, **({"reps": 5, "windows": 3}
                                             if route == "recompute" else {}))
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    cot_t = cot.transpose(1, 2).contiguous()
    library_ms = smoke.time_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), cot_t, retain_graph=True), reps=10, windows=3)[0]
    peak = smoke.PEAK_TF32_FLOPS if f32 else smoke.PEAK_BF16_FLOPS
    t_ops = 10 * d * b * h * smoke.live_pairs(s, s, True, 0) / peak
    t_bytes = (7 * b * s * h * d * q.element_size() + b * s * h * 4) / smoke.PEAK_BYTES
    return {"route": route, "ms": ms, "host_ms": host_ms,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_share": max(t_ops, t_bytes) * 1e3 / ms, "rel_l2": rel,
            "library_ms": library_ms, "library_backend": smoke.sdpa_choice(qt, kt, vt)}


def time_train_step(tree: str, steps: int, args=TRAIN_ARGS,
                    tokens=TRAIN_BATCH * TRAIN_SEQ) -> float:
    """ms per f32 train step of ``tree``'s ``train_lm.py`` with ``args``
    (``tokens`` a step; from its tokens/s over ``steps`` steps)."""
    script = os.path.join(tree, "examples_torch", "llm", "train_lm.py")
    res = subprocess.run([sys.executable, script, *args, "--steps", str(steps)],
                         capture_output=True, text=True, timeout=600, cwd=tree)
    if res.returncode != 0:
        raise RuntimeError(f"{script} failed:\n{res.stderr[-3000:]}")
    m = re.search(r"\(([\d,]+) tokens/sec\)", res.stdout)
    if not m:
        raise RuntimeError(f"no tokens/sec in {script}'s output:\n{res.stdout[-2000:]}")
    tokens_per_s = float(m.group(1).replace(",", ""))
    return tokens / tokens_per_s * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+", help="checkouts, in the order to run them")
    ap.add_argument("--steps", type=int, default=10, help="0: no train step")
    ap.add_argument("--cases", help="comma-separated names of CASES to time (default: all)")
    ap.add_argument("--kernels-of", help=argparse.SUPPRESS)  # the child's mode
    args = ap.parse_args()
    names = set(args.cases.split(",")) if args.cases else None
    known = {c[0] for c in CASES + BWD_CASES}
    if names and not names <= known:
        ap.error(f"unknown cases: {sorted(names - known)}")
    if args.kernels_of:
        print(json.dumps(time_kernels(os.path.abspath(args.kernels_of), names)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"AB card {smi.stdout.strip()}", flush=True)
    for tree in map(os.path.abspath, args.trees):
        cases = ["--cases", args.cases] if args.cases else []
        res = subprocess.run([sys.executable, os.path.abspath(__file__), tree,
                              "--kernels-of", tree, *cases],
                             capture_output=True, text=True, timeout=900, cwd=tree)
        if res.returncode != 0:
            print(res.stderr[-3000:], file=sys.stderr)
            return 1
        result = json.loads(res.stdout.strip().splitlines()[-1])
        if args.steps:
            result["f32_train_step_ms"] = time_train_step(tree, args.steps)
            result["example_lm_f32_train_step_ms"] = time_train_step(
                tree, args.steps, (), EXAMPLE_BATCH * EXAMPLE_SEQ)
        print(f"AB {tree} {json.dumps(result)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
