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

The conv families (``mnist_cnn``, ``resnet50``, ``resnet18``,
``resnet_cifar``, ``inception_v3``) name their submodules as flax does
(``Conv_0``, ``BatchNorm_3``, ``BottleneckBlock_7``, ``InceptionA_1``,
``ConvBN_2``, ``conv_init``, ``bn_init``, ``head``), so a tree path
``a/b/Conv_0/kernel`` is the state-dict key ``a.b.Conv_0.weight``, leaf
by leaf:

| JAX variable                    | shape            | port leaf / shape              |
| ------------------------------- | ---------------- | ------------------------------ |
| ``params/…/Conv_*/kernel``      | [kh, kw, in, out] | ``weight`` [out, in, kh, kw]  |
| ``params/…/Dense_*/kernel``     | [in, out]        | ``weight`` [out, in]           |
| ``params/…/*/bias``             | [out]            | ``bias`` [out]                 |
| ``params/…/BatchNorm_*/scale``  | [C]              | ``weight`` [C]                 |
| ``batch_stats/…/mean``          | [C]              | ``running_mean`` [C]           |
| ``batch_stats/…/var``           | [C]              | ``running_var`` [C]            |

Which layout applies is decided by the bundle's model config
(``{"model": ...}``), never by the keys of the tree.
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


_CONV_FAMILIES = frozenset({"mnist_cnn", "resnet50", "resnet18", "resnet_cifar",
                            "inception_v3"})
_BN_STATS = {"mean": "running_mean", "var": "running_var"}
_FROM_BN_STATS = {v: k for k, v in _BN_STATS.items()}


def _model(config: dict | None) -> str:
    return (config or {}).get("model", "transformer")


def flax_to_torch(variables: dict, config: dict | None = None) -> dict[str, torch.Tensor]:
    """JAX variables → the port model's state dict (CPU tensors in the
    tree's dtype; ``load_state_dict`` casts them).

    ``variables`` is a bare param tree or ``{"params": ...}`` with, for the
    BN families, ``"batch_stats"`` beside it.  ``config`` is the model
    config whose ``"model"`` picks the layout; ``None`` is the transformer.
    """
    if not (isinstance(variables, dict) and "params" in variables):
        variables = {"params": variables}
    model = _model(config)
    if model in _CONV_FAMILIES:
        return _conv_flax_to_torch(variables)
    params = variables["params"]
    if model == "linear":
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


def torch_to_flax(state: dict, n_heads: int | None = None,
                  config: dict | None = None) -> dict:
    """Port state dict → JAX variables (numpy; 16-bit floats widen to f32).

    ``config`` picks the layout as in ``flax_to_torch``.  The transformer
    (``config`` ``None``) gives its bare param tree, and ``n_heads`` splits
    its attention projections; the linear model gives ``{"w", "b"}``; a
    conv family gives ``{"params": ...}``, with ``"batch_stats"`` where the
    state holds running statistics, the tree the JAX ``build_apply`` and
    ``export_bundle`` take.  A ``{name: grad}`` dict converts the same way.
    """
    model = _model(config)
    if model in _CONV_FAMILIES:
        return _conv_torch_to_flax(state)
    if model == "linear":
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


def _walk(tree: dict, path: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def _conv_flax_to_torch(variables: dict) -> dict[str, torch.Tensor]:
    out: dict[str, torch.Tensor] = {}
    for path, leaf in _walk(variables["params"]):
        *mod, name = path
        t = _tensor(leaf)
        if name == "kernel":
            t = t.permute(3, 2, 0, 1) if t.ndim == 4 else t.T      # [out, in, ...]
            out[".".join(mod + ["weight"])] = t.contiguous()
        elif name == "scale":
            out[".".join(mod + ["weight"])] = t
        elif name == "bias":
            out[".".join(mod + ["bias"])] = t
        else:
            raise KeyError(f"unknown param leaf {'/'.join(path)}")
    for path, leaf in _walk(variables.get("batch_stats", {})):
        *mod, name = path
        out[".".join(mod + [_BN_STATS[name]])] = _tensor(leaf)
    return out


def _set(tree: dict, path: list, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _conv_torch_to_flax(state: dict) -> dict:
    params: dict = {}
    stats: dict = {}
    for key, t in state.items():
        *mod, name = key.split(".")
        a = _numpy(t)
        if name in _FROM_BN_STATS:
            _set(stats, mod + [_FROM_BN_STATS[name]], a)
        elif name == "weight":
            if a.ndim == 4:                                       # conv kernel
                _set(params, mod + ["kernel"], np.ascontiguousarray(a.transpose(2, 3, 1, 0)))
            elif a.ndim == 2:                                     # dense kernel
                _set(params, mod + ["kernel"], np.ascontiguousarray(a.T))
            else:                                                 # BN scale
                _set(params, mod + ["scale"], a)
        elif name == "bias":
            _set(params, mod + ["bias"], a)
        else:
            raise KeyError(f"unknown state-dict entry {key}")
    return {"params": params, "batch_stats": stats} if stats else {"params": params}
