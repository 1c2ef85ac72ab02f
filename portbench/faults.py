"""Faults planted under the timed path, to show that the comparison catches
them (``control.py`` on the card, ``tests/test_portbench_faults.py`` here):

- ``unchanged``: the train step computes the loss and returns its state
  unchanged: no backward, no update;
- ``half_batch``: the loss is the mean over the first half of the batch's
  rows, the rest left out.

The exchange between chips has no fault here: every cell is one chip.
"""

from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half_batch")


def _unchanged_step(loss_fn, optimizer, *args, **kwargs):
    import torch

    def step(state, batch):
        with torch.no_grad():
            loss, _ = loss_fn(state.model.train(), batch)
        return state, {"loss": loss}

    return step


def _halve(make_loss_fn):
    def make(model, *args, **kwargs):
        inner = make_loss_fn(model, *args, **kwargs)

        def loss_fn(m, batch):
            return inner(m, {k: v[:len(v) // 2] for k, v in batch.items()})

        return loss_fn

    return make


@contextlib.contextmanager
def planted(name: str | None):
    """The program with fault ``name`` planted while the block runs
    (``None``: none)."""
    from tensorflowonspark_torch.models import resnet, transformer
    from tensorflowonspark_torch.parallel import dp

    patches = {"unchanged": [(dp, "make_train_step", _unchanged_step)],
               "half_batch": [(transformer, "make_loss_fn", _halve(transformer.make_loss_fn)),
                              (resnet, "make_loss_fn", _halve(resnet.make_loss_fn))],
               None: []}[name]
    saved = [(module, attr, getattr(module, attr)) for module, attr, _ in patches]
    for module, attr, value in patches:
        setattr(module, attr, value)
    try:
        yield
    finally:
        for module, attr, value in saved:
            setattr(module, attr, value)
