"""Parameter layouts: the JAX package's param trees (flax names, numpy
arrays, as a bundle holds them) ↔ the port's state dicts.

The transformer:

| JAX param                      | shape      | port key / shape                    |
| ------------------------------ | ---------- | ----------------------------------- |
| ``attn/{q,k,v}_proj/kernel``   | [D, H, Dh] | ``attn.{q,k,v}_proj.weight`` [H·Dh, D] |
| ``attn/o_proj/kernel``         | [H, Dh, D] | ``attn.o_proj.weight`` [D, H·Dh]    |
| ``mlp/{gate,up}_proj/kernel``  | [D, F]     | ``mlp.{gate,up}_proj.weight`` [F, D] |
| ``mlp/down_proj/kernel``       | [F, D]     | ``mlp.down_proj.weight`` [D, F]     |
| ``lm_head/kernel``             | [D, V]     | ``lm_head.weight`` [V, D]           |
| ``embed/embedding``            | [V, D]     | ``embed.weight`` [V, D]             |
| ``*_norm/scale``               | [D]        | ``*_norm.scale`` [D]                |

``block_{i}`` in the tree is ``blocks.{i}`` in the state dict.  A
``{name: grad}`` dict of a trained model converts like its state dict, so
gradients and trained weights go back to the JAX layout leaf by leaf (and
``checkpoint.export_bundle`` of ``torch_to_flax(model.state_dict(), H)``
is a bundle the serving slice loads).

The linear model (``models/linear.py``): ``w`` [in, out] is ``weight``
[out, in], ``b`` [out] is ``bias`` [out].
"""

from __future__ import annotations

import numpy as np
import torch

_QKV = ("q_proj", "k_proj", "v_proj")
_MLP = ("gate_proj", "up_proj", "down_proj")


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()  # master weights are f32
    return t.numpy()


def flax_to_torch(params: dict) -> dict[str, torch.Tensor]:
    """JAX ``Transformer`` (or ``linear``) params → the port model's state
    dict (CPU tensors in the tree's dtype; ``load_state_dict`` casts them)."""
    if set(params) == {"w", "b"}:
        return {"weight": _tensor(params["w"]).T.contiguous(),
                "bias": _tensor(params["b"])}
    out = {"embed.weight": _tensor(params["embed"]["embedding"])}
    i = 0
    while f"block_{i}" in params:
        blk = params[f"block_{i}"]
        if "moe" in blk:
            raise NotImplementedError(
                "MoE blocks are not ported yet: ROADMAP.md queue 1 (e)")
        pre = f"blocks.{i}."
        for name in _QKV:
            w = _tensor(blk["attn"][name]["kernel"])                # [D, H, Dh]
            out[pre + f"attn.{name}.weight"] = w.reshape(w.shape[0], -1).T.contiguous()
        w = _tensor(blk["attn"]["o_proj"]["kernel"])                # [H, Dh, D]
        out[pre + "attn.o_proj.weight"] = w.reshape(-1, w.shape[-1]).T.contiguous()
        for name in _MLP:
            out[pre + f"mlp.{name}.weight"] = \
                _tensor(blk["mlp"][name]["kernel"]).T.contiguous()
        for norm in ("attn_norm", "mlp_norm"):
            out[pre + f"{norm}.scale"] = _tensor(blk[norm]["scale"])
        i += 1
    out["final_norm.scale"] = _tensor(params["final_norm"]["scale"])
    out["lm_head.weight"] = _tensor(params["lm_head"]["kernel"]).T.contiguous()
    return out


def torch_to_flax(state: dict, n_heads: int | None = None) -> dict:
    """Port state dict → JAX param tree (numpy; 16-bit floats widen to f32).
    ``n_heads`` splits the transformer's attention projections; the linear
    model needs none."""
    if set(state) == {"weight", "bias"}:
        return {"w": np.ascontiguousarray(_numpy(state["weight"]).T),
                "b": _numpy(state["bias"])}
    tree: dict = {"embed": {"embedding": _numpy(state["embed.weight"])}}
    i = 0
    while f"blocks.{i}.attn.q_proj.weight" in state:
        pre = f"blocks.{i}."
        attn: dict = {}
        for name in _QKV:
            w = _numpy(state[pre + f"attn.{name}.weight"])          # [H·Dh, D]
            attn[name] = {"kernel": np.ascontiguousarray(
                w.T.reshape(w.shape[1], n_heads, -1))}
        w = _numpy(state[pre + "attn.o_proj.weight"])               # [D, H·Dh]
        attn["o_proj"] = {"kernel": np.ascontiguousarray(
            w.T.reshape(n_heads, -1, w.shape[0]))}
        tree[f"block_{i}"] = {
            "attn": attn,
            "mlp": {name: {"kernel": np.ascontiguousarray(
                _numpy(state[pre + f"mlp.{name}.weight"]).T)} for name in _MLP},
            "attn_norm": {"scale": _numpy(state[pre + "attn_norm.scale"])},
            "mlp_norm": {"scale": _numpy(state[pre + "mlp_norm.scale"])},
        }
        i += 1
    tree["final_norm"] = {"scale": _numpy(state["final_norm.scale"])}
    tree["lm_head"] = {"kernel": np.ascontiguousarray(
        _numpy(state["lm_head.weight"]).T)}
    return tree
