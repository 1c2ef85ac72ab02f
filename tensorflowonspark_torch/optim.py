"""The optax transforms the port needs that ``torch.optim`` does not have
with optax's arithmetic.

``optax.sgd(lr)`` is ``torch.optim.SGD(params, lr)`` (no momentum), and
``optax.adamw(lr)`` is ``parallel.dp.adamw``.  ``optax.adagrad`` is not
``torch.optim.Adagrad``:

- optax starts the accumulator at ``initial_accumulator_value`` (0.1),
  torch at 0;
- optax adds ``eps`` (1e-7) inside the square root, ``g / sqrt(acc +
  eps)``, torch adds 1e-10 outside it;
- optax's ``scale_by_rss`` gives a zero update where the accumulator is 0.
"""

from __future__ import annotations

import torch


class Adagrad(torch.optim.Optimizer):
    """``optax.adagrad(lr, initial_accumulator_value, eps)``: per element,
    ``acc += g²`` then ``p -= lr · g / sqrt(acc + eps)`` (0 where ``acc`` is
    0).  The accumulator is the state ``"sum_of_squares"``, allocated at
    construction so a fresh optimizer's ``state_dict`` is complete.

    The update runs as PyTorch's for-each ops over all parameters of a group
    (a handful of calls, not a handful per parameter: on the card the
    host's launches otherwise take longer than the update)."""

    def __init__(self, params, lr: float, initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7):
        if initial_accumulator_value < 0:
            raise ValueError("initial_accumulator_value must be >= 0")
        super().__init__(params, {"lr": lr, "eps": eps,
                                  "initial_accumulator_value": initial_accumulator_value})
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p]["sum_of_squares"] = torch.full_like(
                    p, group["initial_accumulator_value"],
                    memory_format=torch.preserve_format)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            accs = [self.state[p]["sum_of_squares"] for p in params]
            torch._foreach_addcmul_(accs, grads, grads)
            scales = torch._foreach_add(accs, group["eps"])
            torch._foreach_rsqrt_(scales)
            if group["initial_accumulator_value"] == 0:
                # an accumulator never falls below its start, so only one
                # that starts at 0 can be 0: optax's zero update there
                for scale, acc in zip(scales, accs):
                    scale.masked_fill_(acc == 0, 0.0)
            torch._foreach_mul_(scales, grads)
            torch._foreach_add_(params, scales, alpha=-group["lr"])
        return loss
