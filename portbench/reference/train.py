"""A few training steps of a plain model, written out: the optimizers as
their papers state them, and the numbers the comparison reads.

``loss_fn(params, buffers, batch) -> loss`` is the plain model's loss; it may
move ``buffers`` in place (batch norm's running averages).  The readings:
``loss`` of each step, ``grad_norm`` of each parameter at the first step,
and ``change_norm`` of each parameter and buffer after the last step.
"""

from __future__ import annotations

import torch


def _adamw(opt: dict):
    b1, b2 = opt["betas"]
    lr, eps, wd = opt["lr"], opt["eps"], opt["weight_decay"]

    def update(p, g, state, t):
        m = state.setdefault("m", torch.zeros_like(p))
        v = state.setdefault("v", torch.zeros_like(p))
        p.mul_(1 - lr * wd)                      # decoupled weight decay
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        m_hat = m / (1 - b1 ** t)
        v_hat = v / (1 - b2 ** t)
        p.sub_(lr * m_hat / (v_hat.sqrt() + eps))

    return update


def _sgd(opt: dict):
    lr, mu, nesterov = opt["lr"], opt["momentum"], opt["nesterov"]

    def update(p, g, state, t):
        if "buf" not in state:
            state["buf"] = g.clone()
        else:
            state["buf"].mul_(mu).add_(g)
        p.sub_(lr * (g + mu * state["buf"] if nesterov else state["buf"]))

    return update


OPTIMIZERS = {"adamw": _adamw, "sgd": _sgd}


def readings(loss_fn, weights: dict, buffers: dict, batches: list, optimizer: dict) -> dict:
    """Train a float copy of ``weights`` (and of ``buffers``) for
    ``len(batches)`` steps; the inputs themselves are left as they are."""
    update = OPTIMIZERS[optimizer["name"]](optimizer)
    params = {n: w.detach().clone().requires_grad_() for n, w in weights.items()}
    moving = {n: b.detach().clone() for n, b in buffers.items()}
    state = {n: {} for n in params}
    out = {"loss": [], "grad_norm": {}, "change_norm": {}}
    for t, batch in enumerate(batches, start=1):
        loss = loss_fn(params, moving, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        out["loss"].append(loss.item())
        with torch.no_grad():
            for (name, p), g in zip(params.items(), grads):
                if t == 1:
                    out["grad_norm"][name] = torch.linalg.vector_norm(g).item()
                update(p, g, state[name], t)
        del grads, loss
    with torch.no_grad():
        for name, p in params.items():
            out["change_norm"][name] = torch.linalg.vector_norm(p - weights[name]).item()
        for name, b in moving.items():
            out["change_norm"][name] = torch.linalg.vector_norm(b - buffers[name]).item()
    return out
