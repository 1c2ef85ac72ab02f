"""Tensor (model) parallelism over the ``tp`` axis — counterpart of
``tensorflowonspark_tpu/parallel/tp.py``.

The JAX package annotates parameters with Megatron layouts and lets GSPMD
insert the collectives.  Here each rank holds its local block of every
parameter (``shard_model``) and the layers issue the collectives
themselves, Megatron's way: ``copy_to`` (identity forward, all-reduce of
the gradient) in front of a column-parallel product, ``reduce_from``
(all-reduce forward, identity backward) behind a row-parallel one, and
``gather_from`` (all-gather forward, this rank's slice of the gradient
backward) where a sharded result must be whole, as the vocab-sharded
logits.  Attention therefore sees local q/k/v: the heads of this ``tp``
rank (and, under ``sp``, the sequence of this ``sp`` rank), which is what
the CUDA kernel takes.  ``fsdp`` shards ride on top (``compose_fsdp``): a
parametrization all-gathers the block at each use and sums the gradient
back over ``fsdp`` (ZeRO-3).

Rules are ``(name_regex, P)`` pairs matched against the port's dotted
parameter names; first match wins, no match ⇒ replicated over ``tp``.
``RULE_TABLE`` restates each of the JAX package's rules
(``TRANSFORMER_TP_RULES``, flax names and ``[in, out]`` layouts) on the
port's names and ``[out, in]`` layouts.
"""

from __future__ import annotations

import re
from typing import Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.utils import parametrize

from tensorflowonspark_torch.parallel.mesh import (
    BATCH_AXES,
    P,
    Sharding,
    axis_index,
    axis_size,
    device_of,
    group,
    local_shard,
    pick_shard_dim,
    replicated,
)

Rules = Sequence[tuple[str, P]]

# (JAX rule, its spec, the port's rule, its spec): the port stores q/k/v as
# [H·Dh, D] (flax [D, H, Dh]), o_proj as [D, H·Dh] (flax [H, Dh, D]), the
# MLP and lm_head transposed, the router as [E, D]; the expert stacks keep
# flax's [E, D, F] / [E, F, D]
RULE_TABLE = (
    (r"(q_proj|k_proj|v_proj)/kernel$", P(None, "tp", None),
     r"(q_proj|k_proj|v_proj)\.weight$", P("tp", None)),
    (r"o_proj/kernel$", P("tp", None, None),
     r"o_proj\.weight$", P(None, "tp")),
    (r"(up_proj|gate_proj)/kernel$", P(None, "tp"),
     r"(up_proj|gate_proj)\.weight$", P("tp", None)),
    (r"down_proj/kernel$", P("tp", None),
     r"down_proj\.weight$", P(None, "tp")),
    (r"embed/embedding$", P("tp", None),
     r"embed\.weight$", P("tp", None)),
    (r"lm_head/kernel$", P(None, "tp"),
     r"lm_head\.weight$", P("tp", None)),
    (r"experts_(up|gate)$", P("ep", None, "tp"),
     r"experts_(up|gate)$", P("ep", None, "tp")),
    (r"experts_down$", P("ep", "tp", None),
     r"experts_down$", P("ep", "tp", None)),
    (r"router/kernel$", P(),
     r"router\.weight$", P()),
)
TRANSFORMER_TP_RULES: Rules = tuple((port, spec) for _, _, port, spec in RULE_TABLE)


def param_name(name: str) -> str:
    """A parameter's name without the parametrization that gathers it
    (``a.parametrizations.weight.original`` → ``a.weight``)."""
    return re.sub(r"\.parametrizations\.(\w+)\.original$", r".\1", name)


def rule_shardings(mesh, tree: dict, rules: Rules, *, default: P = P()) -> dict:
    """Per-leaf ``Sharding``s of ``{name: tensor}`` from name-regex rules
    (first match wins)."""
    compiled = [(re.compile(pat), s) for pat, s in rules]

    def leaf(name):
        for pat, s in compiled:
            if pat.search(name):
                return Sharding(mesh, s)
        return Sharding(mesh, default)

    return {k: leaf(param_name(k)) for k in tree}


def compose_fsdp(mesh, tree: dict, shardings: dict) -> dict:
    """Layer fsdp sharding on top of tp rules: any leaf dim not already
    sharded is split over ``fsdp`` (largest divisible dim), so TP and
    ZeRO-3 compose the way Megatron-LM + FSDP do."""
    size = axis_size(mesh, "fsdp")

    def leaf(x, sharding):
        if size == 1 or len(x.shape) == 0:
            return sharding
        entries = list(sharding.spec) + [None] * (len(x.shape) - len(sharding.spec))
        if any("fsdp" in sharding.axes_of(d) for d in range(len(x.shape))):
            return sharding
        taken = tuple(d for d, e in enumerate(entries) if e is not None)
        d = pick_shard_dim(tuple(x.shape), size, taken)
        if d is None:
            return sharding
        entries[d] = "fsdp"
        return Sharding(mesh, P(*entries))

    return {k: leaf(x, shardings[k]) for k, x in tree.items()}


def constrain(x: torch.Tensor, spec: P, mesh=None) -> torch.Tensor:
    """Lay ``x``, replicated over the spec's axes, out as ``spec``: this
    rank's block of it (plain slicing, so the gradient is this block's
    alone).  A no-op outside a mesh; axes of size 1 are dropped, and the
    batch axes are skipped (a batch arrives as each rank's own rows)."""
    if mesh is None:
        return x
    clean = P(*(tuple(a for a in (e if isinstance(e, tuple) else (e,))
                      if a is not None and a not in BATCH_AXES
                      and axis_size(mesh, a) > 1) or None
                for e in spec))
    if all(e is None for e in clean):
        return x
    return local_shard(x, Sharding(mesh, clean))


# ---------------------------------------------------------------------------
# Collectives with their gradients (no-ops when the group is None).
# ---------------------------------------------------------------------------

def _all_reduce(x: torch.Tensor, grp) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=grp)
    return x


def _all_gather(x: torch.Tensor, dim: int, grp) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(grp))]
    dist.all_gather(parts, x, group=grp)
    return torch.cat(parts, dim=dim)


def _my_part(x: torch.Tensor, dim: int, grp) -> torch.Tensor:
    n = dist.get_world_size(grp)
    return x.chunk(n, dim=dim)[dist.get_rank(grp)].contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.grp), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        return _all_reduce(x, grp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, grp, sum_grads):
        ctx.dim, ctx.grp, ctx.sum_grads = dim, grp, sum_grads
        return _all_gather(x, dim, grp)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grads:
            g = _all_reduce(g, ctx.grp)
        return _my_part(g, ctx.dim, ctx.grp), None, None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return _all_reduce(x, grp)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.grp), None


def all_reduce_sum(x: torch.Tensor, grp) -> torch.Tensor:
    """``x`` summed over ``grp``, where every rank goes on to compute
    something else from the sum (BatchNorm's global statistics): the
    gradient is the sum of the ranks' gradients (``reduce_from``'s is the
    rank's own, for a result every rank uses alike)."""
    return x if grp is None else _AllReduceSum.apply(x, grp)


def bind_batch_group(model: nn.Module, mesh) -> None:
    """Give every module with a ``batch_group`` attribute (``BatchNorm``)
    the group of the mesh's batch axes (``None`` on one rank)."""
    grp = group(mesh, *BATCH_AXES)
    for m in model.modules():
        if hasattr(m, "batch_group"):
            m.batch_group = grp


def copy_to(x: torch.Tensor, grp) -> torch.Tensor:
    """Megatron's ``f``: identity forward, gradient all-reduced over
    ``grp`` — in front of a product whose weight is split over ``grp``."""
    return x if grp is None else _CopyTo.apply(x, grp)


def reduce_from(x: torch.Tensor, grp) -> torch.Tensor:
    """Megatron's ``g``: the partial results of ``grp`` summed, gradient
    passed through."""
    return x if grp is None else _ReduceFrom.apply(x, grp)


def gather_from(x: torch.Tensor, dim: int, grp, sum_grads: bool = False) -> torch.Tensor:
    """The blocks of ``grp`` concatenated along ``dim``.  The gradient is
    this rank's block of the incoming one: right when every rank of
    ``grp`` computes the same thing from the result.  ``sum_grads`` sums
    the incoming gradients over ``grp`` first (a reduce-scatter), for a
    result the ranks use differently (an fsdp weight, a sequence each
    rank reads in part)."""
    return x if grp is None else _GatherFrom.apply(x, dim, grp, sum_grads)


class _FsdpGather(nn.Module):
    """Parametrization: the local fsdp block of a weight in, the whole
    (tp-local) weight out; the gradient reduce-scattered back over fsdp."""

    def __init__(self, dim: int, grp):
        super().__init__()
        self.dim, self.grp = dim, grp

    def forward(self, local):
        return gather_from(local, self.dim, self.grp, sum_grads=True)


def shard_model(model: nn.Module, mesh, rules: Rules = TRANSFORMER_TP_RULES,
                fsdp: bool = True) -> nn.Module:
    """Cut ``model``'s parameters to this rank's blocks, in place, and wire
    its layers to the mesh's groups.

    Shardings come from ``rules`` (``rule_shardings``) and, with ``fsdp``,
    ``compose_fsdp``; the parameters are cut by ``local_shard`` and moved
    to the mesh's device; an fsdp-sharded one is gathered at each use by
    a parametrization.  Every module with a ``tp_group``/``ep_group``
    attribute (the transformer's attention, MLP, MoE, embedding and head)
    gets the mesh's group for that axis, and every ``BatchNorm`` the batch
    axes' group (``bind_batch_group``).  ``rules=()`` with ``fsdp`` is the
    JAX package's ``shard_tree(mesh, params)`` of the image models: each
    parameter split over ``fsdp`` on its largest divisible dim, the running
    statistics (buffers) replicated.  The shardings by parameter name
    are kept as ``model.tos_shardings`` (``dp.make_train_step`` reads them
    to reduce gradients; ``gather_full`` to reassemble).  Every rank must
    hold the same full weights before the call."""
    params = dict(model.named_parameters())
    shardings = rule_shardings(mesh, params, rules)
    if fsdp:
        shardings = compose_fsdp(mesh, params, shardings)
    fsdp_grp = group(mesh, "fsdp")
    dev = device_of(mesh)
    for name, p in params.items():
        s = shardings[name]
        spec = s.spec
        owner_name, _, attr = name.rpartition(".")
        owner = model.get_submodule(owner_name) if owner_name else model
        tp_ep = Sharding(mesh, P(*(e if e != "fsdp" else None for e in spec)))
        local = local_shard(p.detach(), tp_ep)
        fsdp_dim = next((d for d in range(len(spec)) if "fsdp" in s.axes_of(d)), None)
        if fsdp_dim is not None and fsdp_grp is not None:
            block = local.chunk(axis_size(mesh, "fsdp"), dim=fsdp_dim)[
                axis_index(mesh, "fsdp")]
            setattr(owner, attr, nn.Parameter(block.to(dev).contiguous().clone(),
                                              requires_grad=p.requires_grad))
            parametrize.register_parametrization(owner, attr,
                                                 _FsdpGather(fsdp_dim, fsdp_grp),
                                                 unsafe=True)
        else:
            setattr(owner, attr, nn.Parameter(local.to(dev).contiguous().clone(),
                                              requires_grad=p.requires_grad))
    tp_grp, ep_grp = group(mesh, "tp"), group(mesh, "ep")
    for m in model.modules():
        if hasattr(m, "tp_group"):
            m.tp_group = tp_grp
        if hasattr(m, "ep_group"):
            m.ep_group = ep_grp
    bind_batch_group(model, mesh)
    model.tos_shardings = {param_name(k): v for k, v in shardings.items()}
    return model


def gather_full(mesh, tree: dict, shardings: dict) -> dict:
    """The inverse of ``mesh.shard_tree``: each local block of ``{name:
    tensor}`` all-gathered along its sharded dims into the whole tensor
    (collective: every rank calls it with the same names)."""
    out = {}
    for k, x in tree.items():
        s = shardings.get(param_name(k), replicated(mesh))
        for d in reversed(range(len(x.shape))):
            for a in reversed(s.axes_of(d)):
                x = gather_from(x.detach(), d, group(mesh, a))
        out[param_name(k)] = x
    return out


def full_parameters(model: nn.Module, mesh, grads: bool = False) -> dict:
    """``{name: whole tensor}`` of a ``shard_model``-ed model's parameters
    (or, with ``grads``, of their gradients); a model never sharded gives
    its own."""
    local = {}
    for k, p in model.named_parameters():
        t = p.grad if grads else p
        local[k] = t.detach() if t is not None else torch.zeros_like(p)
    return gather_full(mesh, local, getattr(model, "tos_shardings", {}))
