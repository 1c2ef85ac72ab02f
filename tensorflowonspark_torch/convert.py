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
| ``moe/router/kernel``          | [D, E]     | ``moe.router.weight`` [E, D]        |
| ``moe/experts_{gate,up}``      | [E, D, F]  | ``moe.experts_{gate,up}`` [E, D, F] |
| ``moe/experts_down``           | [E, F, D]  | ``moe.experts_down`` [E, F, D]      |

A MoE block (``n_experts > 0``) has ``moe`` where a dense one has ``mlp``.

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

Wide-and-deep (``wide_deep``, and ``wide_deep_dense`` without the two
tables) keeps flax's names too, leaf by leaf:

| JAX param                  | shape        | port key / shape               |
| -------------------------- | ------------ | ------------------------------ |
| ``embeddings``             | [26·V, D]    | ``embeddings`` [26·V, D]       |
| ``wide_weights``           | [26·V, 1]    | ``wide_weights`` [26·V, 1]     |
| ``wide_numeric/kernel``    | [13, 1]      | ``wide_numeric.weight`` [1, 13] |
| ``Dense_{i}/kernel``       | [in, out]    | ``Dense_{i}.weight`` [out, in] |
| ``deep_head/kernel``       | [in, 1]      | ``deep_head.weight`` [1, in]   |
| ``*/bias``                 | [out]        | ``*.bias`` [out]               |

Which layout applies is decided by the bundle's model config
(``{"model": ...}``), never by the keys of the tree.
"""

from __future__ import annotations

import numpy as np
import torch

_QKV = ("q_proj", "k_proj", "v_proj")
_MLP = ("gate_proj", "up_proj", "down_proj")
_EXPERTS = ("experts_gate", "experts_up", "experts_down")  # flax's layout both sides


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
_WIDE_DEEP = frozenset({"wide_deep", "wide_deep_dense"})
_TABLES = frozenset({"embeddings", "wide_weights"})  # same name and layout
_BN_BUFFERS = {"mean": "running_mean", "var": "running_var"}
_FROM_BN_BUFFERS = {v: k for k, v in _BN_BUFFERS.items()}


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
    if model in _CONV_FAMILIES or model in _WIDE_DEEP:
        return _leafwise_flax_to_torch(variables)
    params = variables["params"]
    if model == "linear":
        return {"weight": _tensor(params["w"]).T.contiguous(),
                "bias": _tensor(params["b"])}
    out = {"embed.weight": _tensor(params["embed"]["embedding"])}
    i = 0
    while f"block_{i}" in params:
        out.update(_block_to_torch(params[f"block_{i}"], f"blocks.{i}."))
        i += 1
    out["final_norm.scale"] = _tensor(params["final_norm"]["scale"])
    out["lm_head.weight"] = _tensor(params["lm_head"]["kernel"]).T.contiguous()
    return out


def _block_to_torch(blk: dict, pre: str) -> dict[str, torch.Tensor]:
    """One transformer ``Block``'s params → its state-dict entries under
    ``pre``."""
    out = {}
    for name in _QKV:
        w = _tensor(blk["attn"][name]["kernel"])                    # [D, H, Dh]
        out[pre + f"attn.{name}.weight"] = w.reshape(w.shape[0], -1).T.contiguous()
    w = _tensor(blk["attn"]["o_proj"]["kernel"])                    # [H, Dh, D]
    out[pre + "attn.o_proj.weight"] = w.reshape(-1, w.shape[-1]).T.contiguous()
    if "moe" in blk:
        moe = blk["moe"]
        out[pre + "moe.router.weight"] = _tensor(moe["router"]["kernel"]).T.contiguous()
        for name in _EXPERTS:
            out[pre + f"moe.{name}"] = _tensor(moe[name])
    else:
        for name in _MLP:
            out[pre + f"mlp.{name}.weight"] = \
                _tensor(blk["mlp"][name]["kernel"]).T.contiguous()
    for norm in ("attn_norm", "mlp_norm"):
        out[pre + f"{norm}.scale"] = _tensor(blk[norm]["scale"])
    return out


def stages_to_torch(stacked: dict) -> dict[str, torch.Tensor]:
    """The JAX package's stage-stacked tree of transformer ``Block`` params
    (``parallel.pp.stack_stages`` over per-stage stacks of blocks: every
    leaf ``[n_stages, blocks_per_stage, …]``, numpy) → the port's
    stage-stacked tree for ``parallel.pp``: ``{"blocks.{j}.…": [n_stages,
    …]}``, the names of ``models.transformer.Stage``."""
    def take(tree, idx):
        return ({k: take(v, idx) for k, v in tree.items()} if isinstance(tree, dict)
                else np.asarray(tree)[idx])

    lead = next(v for _, v in _walk(stacked))
    n_stages, per_stage = np.shape(lead)[:2]
    stages = []
    for i in range(n_stages):
        stage: dict = {}
        for j in range(per_stage):
            stage.update(_block_to_torch(take(stacked, (i, j)), f"blocks.{j}."))
        stages.append(stage)
    return {k: torch.stack([s[k] for s in stages]) for k in stages[0]}


def torch_to_flax(state: dict, n_heads: int | None = None,
                  config: dict | None = None) -> dict:
    """Port state dict → JAX variables (numpy; 16-bit floats widen to f32).

    ``config`` picks the layout as in ``flax_to_torch``.  The transformer
    (``config`` ``None``) gives its bare param tree, and ``n_heads`` splits
    its attention projections; the linear model gives ``{"w", "b"}``, and
    wide-and-deep its bare param tree; a
    conv family gives ``{"params": ...}``, with ``"batch_stats"`` where the
    state holds running statistics, the tree the JAX ``build_apply`` and
    ``export_bundle`` take.  A ``{name: grad}`` dict converts the same way.
    """
    model = _model(config)
    if model in _CONV_FAMILIES:
        return _leafwise_torch_to_flax(state)
    if model in _WIDE_DEEP:
        return _leafwise_torch_to_flax(state)["params"]
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
            "attn_norm": {"scale": _numpy(state[pre + "attn_norm.scale"])},
            "mlp_norm": {"scale": _numpy(state[pre + "mlp_norm.scale"])},
        }
        if pre + "moe.router.weight" in state:
            tree[f"block_{i}"]["moe"] = {
                "router": {"kernel": np.ascontiguousarray(
                    _numpy(state[pre + "moe.router.weight"]).T)},
                **{name: _numpy(state[pre + f"moe.{name}"]) for name in _EXPERTS}}
        else:
            tree[f"block_{i}"]["mlp"] = {
                name: {"kernel": np.ascontiguousarray(
                    _numpy(state[pre + f"mlp.{name}.weight"]).T)} for name in _MLP}
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


def _leafwise_flax_to_torch(variables: dict) -> dict[str, torch.Tensor]:
    out: dict[str, torch.Tensor] = {}
    for path, leaf in _walk(variables["params"]):
        *mod, name = path
        t = _tensor(leaf)
        if not mod and name in _TABLES:
            out[name] = t
        elif name == "kernel":
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
        out[".".join(mod + [_BN_BUFFERS[name]])] = _tensor(leaf)
    return out


def _set(tree: dict, path: list, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _leafwise_torch_to_flax(state: dict) -> dict:
    params: dict = {}
    stats: dict = {}
    for key, t in state.items():
        *mod, name = key.split(".")
        a = _numpy(t)
        if not mod and name in _TABLES:
            params[name] = a
        elif name in _FROM_BN_BUFFERS:
            _set(stats, mod + [_FROM_BN_BUFFERS[name]], a)
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
