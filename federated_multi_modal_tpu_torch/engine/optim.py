"""The optimizer chain (port of ``federated_multi_modal_tpu/engine/optim.py::
build_optimizer`` and ``tx_with_lr``, SGD branch): a functional chain in
optax's order, applied to parameter trees of the port.

    clip_by_global_norm(clip) -> add_decayed_weights(wd)
        -> trace(momentum, nesterov) -> scale(-lr)

That is torch SGD's arithmetic (``buf = m * buf + (g + wd * p)``, update
``-lr * buf``) with the reference's global-norm clip applied to the raw
gradients first. It is kept as one pure function of (gradients, state,
params), so that a train step can keep or drop the new state as a whole
(the non-finite skip), where ``torch.optim.SGD`` updates in place; and the
clip scales by optax's ``clip / norm``, where ``clip_grad_norm_`` scales by
``clip / (norm + 1e-6)``. Adam and AdamW are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from federated_multi_modal_tpu_torch.engine.tree import leaves, tree_map_multi


def global_norm(tree) -> torch.Tensor:
    """fp32 ``sqrt(sum of squares)`` over every leaf of ``tree``."""
    return torch.sqrt(sum(g.float().square().sum() for g in leaves(tree)))


@dataclasses.dataclass(frozen=True)
class SGD:
    """SGD with momentum, coupled weight decay and an optional global-norm
    clip. ``init(params)`` gives the state ``{"trace": momentum tree}``;
    ``update(grads, state, params)`` gives ``(updates, new state)``, the
    updates to be added to the params."""

    lr: float
    momentum: float = 0.9
    weight_decay: float = 0.0
    nesterov: bool = False
    clip: float = 0.0

    def init(self, params):
        return {"trace": tree_map_multi(torch.zeros_like, params)}

    def update(self, grads, state, params):
        if self.clip and self.clip > 0:
            g_norm = global_norm(grads)
            keep = g_norm < self.clip
            grads = tree_map_multi(
                lambda g: torch.where(keep, g, (g / g_norm.to(g.dtype)) * self.clip),
                grads)
        if self.weight_decay:
            grads = tree_map_multi(lambda g, p: g + self.weight_decay * p,
                                   grads, params)
        trace = tree_map_multi(lambda g, t: g + self.momentum * t,
                               grads, state["trace"])
        if self.nesterov:
            updates = tree_map_multi(lambda g, t: g + self.momentum * t, grads, trace)
        else:
            updates = trace
        updates = tree_map_multi(lambda u: u * -self.lr, updates)
        return updates, {"trace": trace}


def build_optimizer(lr: float = 0.0003, momentum: float = 0.9,
                    weight_decay: float = 5e-4, nesterov: bool = False,
                    clip: float = 0.0) -> SGD:
    """The JAX package's ``build_optimizer`` for its SGD branch (the only
    one ported), with the config defaults of ``config/defaults.py``
    (``OPTIM.*``)."""
    return SGD(lr=lr, momentum=momentum, weight_decay=weight_decay,
               nesterov=nesterov, clip=clip)
