"""A toy architecture for the harness's tests, not CLIP's: a two-layer
perceptron over nearest-neighbour crops, trained by SGD. A test writes this
file into a benchmark root as ``benchmark/architectures/toy.py``; it
exports the pieces that ``benchmark/harness.py`` lists for an architecture.

Its configuration gives ``image_resolution``, ``hidden``, ``n_classes``,
``classnames`` and ``optim``. The system and the reference are separate
plain PyTorch code in float32, so they agree to rounding.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.traffic.weights import generator

_STREAM = 0x70E0001


def _sizes(cfg: dict) -> tuple:
    return 3 * cfg["image_resolution"] ** 2, cfg["hidden"], cfg["n_classes"]


def state_dict(cfg: dict, seed: int, device) -> dict:
    d_in, hidden, classes = _sizes(cfg)
    gen = generator(seed, _STREAM, device)
    w1 = torch.randn(hidden, d_in, generator=gen, device=device) * d_in ** -0.5
    w2 = torch.randn(classes, hidden, generator=gen, device=device) * hidden ** -0.5
    return {"fc1.weight": w1, "fc1.bias": torch.zeros(hidden, device=device),
            "fc2.weight": w2, "fc2.bias": torch.zeros(classes, device=device)}


def prompt_learner(cfg: dict, use_captions: bool, seed: int, device) -> dict:
    return {}


def crop(canvas, boxes, flips, out: int) -> torch.Tensor:
    """Each box sampled at ``out`` x ``out`` nearest points, flipped where
    asked: ``(B, 3, out, out)`` in [-0.5, 0.5]."""
    S = canvas.shape[1]
    at = (torch.arange(out, device=canvas.device) + 0.5) / out
    ys = (boxes[:, :1] + at * boxes[:, 2:3]).long().clamp(0, S - 1)
    xs = (boxes[:, 1:2] + at * boxes[:, 3:4]).long().clamp(0, S - 1)
    xs = torch.where(flips[:, None], xs.flip(1), xs)
    rows = torch.arange(canvas.shape[0], device=canvas.device)[:, None, None]
    img = canvas[rows, ys[:, :, None], xs[:, None, :]]
    return img.permute(0, 3, 1, 2).float() / 255.0 - 0.5


def grad_norm(grads: dict) -> float:
    return math.sqrt(sum(float(g.double().square().sum()) for g in grads.values()))


def strict_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False


def reference_rows(cfg: dict, mix: dict, device) -> int:
    return mix["batch"]


def train_step_flops(cfg: dict, mix: dict, text_len: int) -> float:
    d_in, hidden, classes = _sizes(cfg)
    return 6.0 * mix["batch"] * (d_in * hidden + hidden * classes)


def eval_batch_flops(cfg: dict, mix: dict, text_len: int) -> float:
    d_in, hidden, classes = _sizes(cfg)
    return 2.0 * mix["batch"] * (d_in * hidden + hidden * classes)


def attention_work(cfg: dict, mix: dict, text_len: int) -> list:
    return []


def gemm_work(cfg: dict, mix: dict, text_len: int) -> list:
    flops = train_step_flops(cfg, mix, text_len)
    return [{"flops": flops, "bytes": 4.0 * flops / mix["batch"]}]


class Reference:
    """The perceptron in float32: ``loss_and_grads``, ``step`` (SGD after a
    global-norm clip), ``logits``; ``quant`` rounds the products' operands
    to bfloat16 (the control)."""

    def __init__(self, sd, pl, classnames, cfg, device, quant: bool = False):
        o = cfg["optim"]
        self.lr, self.momentum, self.wd, self.clip = (o["lr"], o["momentum"],
                                                      o["weight_decay"], o["clip_norm"])
        self.quant = quant
        self.params = {k: v.to(device=device, dtype=torch.float32).clone() for k, v in sd.items()}
        self.trainable = sorted(self.params)
        self.trace = {k: torch.zeros_like(v) for k, v in self.params.items()}

    def _q(self, x):
        return x.bfloat16().float() if self.quant else x

    def _forward(self, params, images):
        x = images.flatten(1)
        h = F.relu(F.linear(self._q(x), self._q(params["fc1.weight"]), params["fc1.bias"]))
        return F.linear(self._q(h), self._q(params["fc2.weight"]), params["fc2.bias"])

    def loss_and_grads(self, images, labels, caption_ids, rows: int, take=None):
        idx = torch.arange(images.shape[0], device=images.device) if take is None else take
        params = {k: v.detach().requires_grad_(True) for k, v in self.params.items()}
        loss = F.cross_entropy(self._forward(params, images[idx]), labels[idx])
        loss.backward()
        return float(loss.detach()), {k: params[k].grad for k in self.trainable}

    def step(self, grads) -> dict:
        norm = math.sqrt(sum(float(g.double().square().sum()) for g in grads.values()))
        factor = 1.0 if norm < self.clip else self.clip / norm
        clipped = {k: g * factor for k, g in grads.items()}
        with torch.no_grad():
            for k, g in clipped.items():
                self.trace[k] = g + self.wd * self.params[k] + self.momentum * self.trace[k]
                self.params[k] = self.params[k] - self.lr * self.trace[k]
        return clipped

    def logits(self, images, rows: int):
        with torch.no_grad():
            return self._forward(self.params, images)


class _System:
    """The program under test: the perceptron as separate matrix products,
    its own SGD, eager steps."""

    @staticmethod
    def build_kernels(device) -> None:
        pass

    @staticmethod
    def build(sd, pl, cfg, classnames, use_captions, device) -> dict:
        return {"params": {k: v.float().clone() for k, v in sd.items()},
                "out": cfg["image_resolution"], "text_len": 0}

    @staticmethod
    def _logits(p, images):
        h = (images.flatten(1) @ p["fc1.weight"].T + p["fc1.bias"]).clamp(min=0)
        return h @ p["fc2.weight"].T + p["fc2.bias"]

    @classmethod
    def train_step(cls, prog, cfg, inputs, draw):
        o = cfg["optim"]

        def step(state, run=None):
            params, opt, bad = state
            boxes, flips = draw()
            images = crop(inputs["canvas"], boxes, flips, prog["out"])
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            loss = F.cross_entropy(cls._logits(leaves, images), inputs["labels"])
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            gnorm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
            scale = torch.clamp(o["clip_norm"] / gnorm, max=1.0)
            trace = {k: grads[k] * scale + o["weight_decay"] * params[k]
                     + o["momentum"] * opt["trace"][k] for k in params}
            params = {k: params[k] - o["lr"] * trace[k] for k in params}
            bad = bad + int(not torch.isfinite(loss))
            return (params, {"trace": trace}, bad), (loss.detach(), gnorm, boxes, flips)

        params = prog["params"]
        return step, (params, {"trace": {k: torch.zeros_like(v) for k, v in params.items()}},
                      torch.zeros((), dtype=torch.int32))

    @classmethod
    def eval_step(cls, prog, inputs, boxes, flips, roll):
        def step(state, run=None):
            canvas, bad = state
            logits = cls._logits(prog["params"], crop(canvas, boxes, flips, prog["out"]))
            bad = bad + (~torch.isfinite(logits).all(-1)).sum(dtype=bad.dtype)
            return (torch.roll(canvas, roll, 0), bad), logits

        return step, (inputs["canvas"].clone(), torch.zeros((), dtype=torch.int32))

    class Runner:
        def __init__(self, step, state, generators=()):
            self.step, self.state, self.out = step, state, None

        def __call__(self):
            self.state, self.out = self.step(self.state)
            return self.out

    @staticmethod
    def trainable_flat(state) -> dict:
        return dict(state[0])

    @staticmethod
    def trace_flat(state) -> dict:
        return dict(state[1]["trace"])


system = _System
