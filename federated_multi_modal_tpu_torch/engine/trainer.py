"""One optimisation step over the trainable split (port of
``federated_multi_modal_tpu/engine/trainer.py::_train_step``)."""

from __future__ import annotations

import torch

from federated_multi_modal_tpu_torch.engine.optim import global_norm
from federated_multi_modal_tpu_torch.engine.tree import (
    flatten,
    tree_map_multi,
    tree_map_with_path,
)


def make_train_step(loss_fn, tx):
    """``train_step(trainable, frozen, opt_state, batch) -> (trainable,
    opt_state, loss, gnorm)`` for ``loss_fn(trainable, frozen, batch) ->
    (loss, aux)`` and an optimizer ``tx`` (``engine/optim.py``).

    The gradient covers every leaf of ``trainable`` (a leaf the loss does
    not reach gets zeros); ``gnorm`` is its fp32 global norm before
    clipping. When ``gnorm`` or the loss is not finite, the step leaves the
    params *and* the optimizer state as they were (the reference zeroes the
    gradients and skips the batch). Nothing is read back to the host."""

    def train_step(trainable, frozen, opt_state, batch):
        tr = tree_map_with_path(lambda _, t: t.detach().requires_grad_(True), trainable)
        flat = flatten(tr)
        loss, _ = loss_fn(tr, frozen, batch)
        got = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
        by_name = {name: torch.zeros_like(leaf) if g is None else g
                   for (name, leaf), g in zip(flat.items(), got)}
        grads = tree_map_with_path(lambda name, _: by_name[name], tr)
        loss = loss.detach()
        gnorm = global_norm(grads)
        finite = torch.isfinite(gnorm) & torch.isfinite(loss)
        updates, new_state = tx.update(grads, opt_state, trainable)
        trainable = tree_map_multi(lambda p, u: torch.where(finite, p + u, p),
                                   trainable, updates)
        opt_state = tree_map_multi(lambda new, old: torch.where(finite, new, old),
                                   new_state, opt_state)
        return trainable, opt_state, loss, gnorm

    return train_step
