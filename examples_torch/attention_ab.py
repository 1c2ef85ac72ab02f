"""Time the attention kernels and the f32 LM train step of several
checkouts on one card, so that two versions are compared within one run:

    python examples_torch/attention_ab.py PARENT_DIR CHANGE_DIR CHANGE_DIR PARENT_DIR

Each directory is a checkout of the repo (for example ``git archive`` of a
commit, unpacked).  For each, in the order given, two child processes run
on the card:

- one imports that checkout's ``tensorflowonspark_torch``, builds its
  kernels, and times ``flash_attn_fwd_cuda`` at ``CASES`` (50 calls back
  to back between two CUDA events behind a spin kernel, median of 5
  windows: ``chip_smoke.time_ms`` of this script's checkout), and reports
  the registers and spills (ptxas) and HGMMA/UTMALDG counts (SASS) of its
  ``wgmma`` instantiations, bf16/fp16 and 3xTF32; where the checkout's
  ``_launch`` takes ``wide``, it also times the wide route at one slice on
  the cases of ``WIDE_ONE_SLICE`` (bf16 D=256, f32 D=128), held against the
  plain version, beside the dedicated configuration of that head dim;
- one runs that checkout's ``examples_torch/llm/train_lm.py`` in f32 at the
  LM width of ``chip_smoke.py`` (vocab 32000, d_model 1024, 8 layers of 8
  heads, B=2, S=2048) for ``--steps`` steps after one warm-up step, and
  reports ms per step from its tokens/s (host clock over the steps).

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
# (name, B, S, H, D, dtype name): causal, Sq == Sk, kv_offset 0
CASES = (("serving_shape", 4, 2048, 8, 128, "bfloat16"),
         ("head_dim_64", 4, 2048, 16, 64, "bfloat16"),
         ("f32_serving_shape", 4, 2048, 8, 128, "float32"),
         ("bf16_d256", 4, 2048, 4, 256, "bfloat16"),
         # the head-dim-256 f32 train step's shape
         ("f32_d256", 2, 2048, 4, 256, "float32"))
# cases also run on the wide route at one slice: whether it could take over
# from the dedicated configuration of the same head dim
WIDE_ONE_SLICE = ("bf16_d256", "f32_serving_shape")
TRAIN_BATCH, TRAIN_SEQ = 2, 2048
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


def time_kernels(tree: str) -> dict:
    """In this process: ``tree``'s kernels timed at ``CASES``, and what
    ptxas and the SASS say of its ``wgmma`` instantiations."""
    sys.path.insert(0, tree)
    import inspect

    import torch

    from tensorflowonspark_torch.ops import attention as att
    from tensorflowonspark_torch.ops import cuda_build

    smoke = _chip_smoke()
    out: dict = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, b, s, h, d, dtype_name in CASES:
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda")
                   .to(getattr(torch, dtype_name)) for _ in range(3))
        out[name] = smoke.time_ms(lambda: att.flash_attn_fwd_cuda(q, k, v, causal=True))[0]
        if name in WIDE_ONE_SLICE and "wide" in inspect.signature(att._launch).parameters:
            route = att._route(q.dtype, d)[0]
            tol = smoke.F32_TOL if dtype_name == "float32" else smoke.O_TOL

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
    report, sass = {}, {}
    for lib in ("flash_attn_fwd", "flash_attn_fwd_tf32"):
        report.update(smoke.ptxas_report(cuda_build.build_log(lib)))
        sass.update(smoke.sass_counts(cuda_build.library_path(lib)))
    out["build"] = {f"{lib}_D{d}_{dt}": {**regs, **sass.get((lib, d, dt), {})}
                    for (lib, d, dt), regs in sorted(report.items(), key=str)}
    return out


def time_train_step(tree: str, steps: int) -> float:
    """ms per f32 train step of ``tree``'s ``train_lm.py`` (from its
    tokens/s over ``steps`` steps)."""
    script = os.path.join(tree, "examples_torch", "llm", "train_lm.py")
    res = subprocess.run([sys.executable, script, *TRAIN_ARGS, "--steps", str(steps)],
                         capture_output=True, text=True, timeout=600, cwd=tree)
    if res.returncode != 0:
        raise RuntimeError(f"{script} failed:\n{res.stderr[-3000:]}")
    m = re.search(r"\(([\d,]+) tokens/sec\)", res.stdout)
    if not m:
        raise RuntimeError(f"no tokens/sec in {script}'s output:\n{res.stdout[-2000:]}")
    tokens_per_s = float(m.group(1).replace(",", ""))
    return TRAIN_BATCH * TRAIN_SEQ / tokens_per_s * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+", help="checkouts, in the order to run them")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--kernels-of", help=argparse.SUPPRESS)  # the child's mode
    args = ap.parse_args()
    if args.kernels_of:
        print(json.dumps(time_kernels(os.path.abspath(args.kernels_of))))
        return 0
    for tree in map(os.path.abspath, args.trees):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), tree,
                              "--kernels-of", tree],
                             capture_output=True, text=True, timeout=900, cwd=tree)
        if res.returncode != 0:
            print(res.stderr[-3000:], file=sys.stderr)
            return 1
        result = json.loads(res.stdout.strip().splitlines()[-1])
        result["f32_train_step_ms"] = time_train_step(tree, args.steps)
        print(f"AB {tree} {json.dumps(result)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
