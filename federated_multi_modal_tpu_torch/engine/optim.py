"""Optimizers and the LR schedule (port of
``federated_multi_modal_tpu/engine/optim.py``): functional chains in optax's
order, applied to parameter trees of the port, and Dassl's per-epoch
schedule with its warmup.

    SGD:   clip_by_global_norm(clip) -> add_decayed_weights(wd)
               -> trace(momentum, nesterov) -> scale(-lr)
    Adam:  clip -> add_decayed_weights(wd) -> scale_by_adam -> scale(-lr)
    AdamW: clip -> scale_by_adam -> add_decayed_weights(wd) -> scale(-lr)

SGD is torch SGD's arithmetic (``buf = m * buf + (g + wd * p)``, update
``-lr * buf``) with the reference's global-norm clip applied to the raw
gradients first. Each optimizer is one pure function of (gradients, state,
params), so that a train step can keep or drop the new state as a whole
(the non-finite skip), where ``torch.optim`` updates in place; and the clip
scales by optax's ``clip / norm``, where ``clip_grad_norm_`` scales by
``clip / (norm + 1e-6)``.

The learning rate lives in the state as a 0-d fp32 tensor, as the JAX
package injects it into optax's state: a schedule step is
:func:`set_learning_rate` on the state, and ``lr`` of the optimizer is only
the value ``init`` starts from. Adam's step count lives there too.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from federated_multi_modal_tpu_torch.engine.tree import leaves, tree_map_multi


def global_norm(tree) -> torch.Tensor:
    """fp32 ``sqrt(sum of squares)`` over every leaf of ``tree``."""
    return torch.sqrt(sum(g.float().square().sum() for g in leaves(tree)))


def _clip_by_global_norm(grads, clip: float):
    g_norm = global_norm(grads)
    keep = g_norm < clip
    return tree_map_multi(
        lambda g: torch.where(keep, g, (g / g_norm.to(g.dtype)) * clip), grads)


def _lr_tensor(params, lr: float) -> torch.Tensor:
    device = leaves(params)[0].device
    return torch.tensor(lr, dtype=torch.float32, device=device)


def _scale_by_lr(updates, state, default_lr: float):
    """``-lr * updates`` with the state's LR (the optimizer's own ``lr``
    for a state made without one)."""
    lr = state.get("lr")
    if lr is None:
        return tree_map_multi(lambda u: u * -default_lr, updates)
    return tree_map_multi(lambda u: u * -lr.to(u.dtype), updates)


def _with_lr(state, new: dict) -> dict:
    """``new`` with the state's LR entry, where it has one."""
    return {"lr": state["lr"], **new} if "lr" in state else new


@dataclasses.dataclass(frozen=True)
class SGD:
    """SGD with momentum, coupled weight decay and an optional global-norm
    clip. ``init(params)`` gives the state ``{"lr": 0-d tensor, "trace":
    momentum tree}``; ``update(grads, state, params)`` gives ``(updates, new
    state)``, the updates to be added to the params. A state made without
    ``"lr"`` (``{"trace": ...}``) runs at ``lr``."""

    lr: float
    momentum: float = 0.9
    weight_decay: float = 0.0
    nesterov: bool = False
    clip: float = 0.0

    def init(self, params):
        return {"lr": _lr_tensor(params, self.lr),
                "trace": tree_map_multi(torch.zeros_like, params)}

    def update(self, grads, state, params):
        if self.clip and self.clip > 0:
            grads = _clip_by_global_norm(grads, self.clip)
        if self.weight_decay:
            grads = tree_map_multi(lambda g, p: g + self.weight_decay * p,
                                   grads, params)
        trace = tree_map_multi(lambda g, t: g + self.momentum * t,
                               grads, state["trace"])
        if self.nesterov:
            updates = tree_map_multi(lambda g, t: g + self.momentum * t, grads, trace)
        else:
            updates = trace
        return _scale_by_lr(updates, state, self.lr), _with_lr(state, {"trace": trace})


@dataclasses.dataclass(frozen=True)
class Adam:
    """Adam (``decoupled=False``: torch Adam's L2, the decay added to the
    gradient before the moments) or AdamW (``decoupled=True``: the decay
    added to the update after them, scaled by the LR), with optax's
    ``scale_by_adam`` arithmetic (eps 1e-8 outside the square root, the bias
    corrections ``1 - b ** count`` in fp32). The state is ``{"lr", "count"
    (0-d int32), "mu", "nu"}``."""

    lr: float
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 0.0
    decoupled: bool = False
    clip: float = 0.0
    eps: float = 1e-8

    def init(self, params):
        zeros = tree_map_multi(torch.zeros_like, params)
        return {"lr": _lr_tensor(params, self.lr),
                "count": torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device),
                "mu": zeros, "nu": tree_map_multi(torch.zeros_like, params)}

    def update(self, grads, state, params):
        if self.clip and self.clip > 0:
            grads = _clip_by_global_norm(grads, self.clip)
        if self.weight_decay and not self.decoupled:
            grads = tree_map_multi(lambda g, p: g + self.weight_decay * p, grads, params)
        b1, b2 = self.beta1, self.beta2
        mu = tree_map_multi(lambda g, m: (1 - b1) * g + b1 * m, grads, state["mu"])
        nu = tree_map_multi(lambda g, n: (1 - b2) * g.square() + b2 * n, grads, state["nu"])
        count = state["count"] + 1
        c = count.float()
        corr1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=c.device), c)
        corr2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=c.device), c)
        updates = tree_map_multi(
            lambda m, n: (m / corr1.to(m.dtype)) / (torch.sqrt(n / corr2.to(n.dtype)) + self.eps),
            mu, nu)
        if self.weight_decay and self.decoupled:
            updates = tree_map_multi(lambda u, p: u + self.weight_decay * p, updates, params)
        return _scale_by_lr(updates, state, self.lr), _with_lr(
            state, {"count": count, "mu": mu, "nu": nu})


def build_optimizer(lr: float = 0.0003, momentum: float = 0.9,
                    weight_decay: float = 5e-4, nesterov: bool = False,
                    clip: float = 0.0) -> SGD:
    """SGD with the config defaults of ``config/defaults.py`` (``OPTIM.*``)."""
    return SGD(lr=lr, momentum=momentum, weight_decay=weight_decay,
               nesterov=nesterov, clip=clip)


def optimizer_from_cfg(cfg_optim, learning_rate: float = None):
    """The JAX package's ``build_optimizer(cfg_optim, learning_rate)``:
    ``OPTIM.NAME`` sgd, adam or adamw with ``OPTIM.*``'s settings and
    ``OPTIM.GRAD_CLIP_NORM``'s clip, starting from ``learning_rate``
    (``OPTIM.LR`` when ``None``)."""
    lr = cfg_optim.LR if learning_rate is None else learning_rate
    clip = getattr(cfg_optim, "GRAD_CLIP_NORM", 0.0)
    name = cfg_optim.NAME.lower()
    if name == "sgd":
        return SGD(lr=lr, momentum=cfg_optim.MOMENTUM, weight_decay=cfg_optim.WEIGHT_DECAY,
                   nesterov=bool(cfg_optim.SGD_NESTEROV), clip=clip)
    if name in ("adam", "adamw"):
        return Adam(lr=lr, beta1=cfg_optim.ADAM_BETA1, beta2=cfg_optim.ADAM_BETA2,
                    weight_decay=cfg_optim.WEIGHT_DECAY, decoupled=name == "adamw",
                    clip=clip)
    raise ValueError(f"Unknown optimizer: {name}")


def set_learning_rate(opt_state, lr: float):
    """The state with its LR set to ``lr`` (a new 0-d fp32 tensor on the
    same device; the other entries are shared)."""
    old = opt_state["lr"]
    return {**opt_state, "lr": torch.tensor(lr, dtype=torch.float32, device=old.device)}


def get_learning_rate(opt_state) -> float:
    return float(opt_state["lr"])


def build_lr_schedule(cfg_optim):
    """``lr(epoch) -> float``, stepped per epoch (a copy of the JAX
    package's): cosine, single_step, multi_step or constant, behind Dassl's
    constant or linear warmup."""
    base_lr = cfg_optim.LR
    max_epoch = cfg_optim.MAX_EPOCH
    warmup_epoch = cfg_optim.WARMUP_EPOCH
    warmup_type = cfg_optim.WARMUP_TYPE
    warmup_cons_lr = cfg_optim.WARMUP_CONS_LR
    warmup_min_lr = cfg_optim.WARMUP_MIN_LR
    scheduler = cfg_optim.LR_SCHEDULER
    stepsize = cfg_optim.STEPSIZE
    gamma = cfg_optim.GAMMA

    def main_lr(epoch: float) -> float:
        if scheduler == "cosine":
            return base_lr * 0.5 * (1.0 + math.cos(math.pi * epoch / max_epoch))
        if scheduler == "single_step":
            # Dassl takes the LAST element of a list-valued STEPSIZE
            step = stepsize[-1] if stepsize and stepsize[-1] > 0 else max_epoch
            return base_lr * (gamma ** (int(epoch) // step))
        if scheduler == "multi_step":
            n_passed = sum(1 for s in stepsize if epoch >= s)
            return base_lr * (gamma ** n_passed)
        if scheduler == "constant":
            return base_lr
        raise ValueError(f"Unknown LR scheduler: {scheduler}")

    warmup_recount = bool(getattr(cfg_optim, "WARMUP_RECOUNT", True))

    def lr(epoch: float) -> float:
        """LR of training epoch ``epoch``: the successor scheduler starts
        stepping once warmup ends, so post-warmup epoch ``e`` runs at its
        counter ``e - warmup`` (``WARMUP_RECOUNT``) or ``e - 1``."""
        if warmup_epoch > 0 and epoch < warmup_epoch:
            if warmup_type == "constant":
                return warmup_cons_lr
            if warmup_type == "linear":
                # Dassl LinearWarmupScheduler: epoch 0 at min_lr, then
                # base_lr * e / warmup
                if epoch == 0:
                    return warmup_min_lr
                return base_lr * epoch / warmup_epoch
            raise ValueError(f"Unknown warmup type: {warmup_type}")
        if warmup_epoch > 0:
            return main_lr(epoch - (warmup_epoch if warmup_recount else 1))
        return main_lr(epoch)

    return lr
