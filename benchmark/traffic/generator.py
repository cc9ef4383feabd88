"""The one traffic generator: what a mix file asks for, made from the seed.

A mix (``benchmark/traffic/<name>.json``) holds parameters only:

* ``kind``: the loop, any ``benchmark/kinds/<kind>.py``: ``train`` (a
  closed loop of optimizer steps on random resized crops, a box drawn on
  the card every step with ``scale``, ``ratio`` and a flip with
  probability ``flip``), ``eval`` (a closed loop of prompt-cached eval
  batches on centre crops: the whole canvas, no flip), or a kind added
  with its file, which reads the parameters it names;
* ``batch``: images a step; ``canvas``: the side of the uint8 canvas each
  image is decoded onto;
* ``roll``: eval only, how many images the canvas moves on after a step;
* ``captions``: whether each image carries a caption, and
  ``caption_tokens``: the least and most word tokens one has;
* ``eval_samples``: eval only, how many batches of the window the seed
  picks for the comparison (the window's last batch is always one).

Canvases are uniform bytes, labels uniform over the classes, captions
uniform token ids between SOT and EOT: every seed gives inputs of the same
sizes, so that the seed changes values and never the work.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import torch

from benchmark import pieces
from benchmark.traffic.weights import generator

_DATA_STREAM, _BOX_STREAM, _PICK_STREAM = 0x5EED0003, 0x5EED0004, 0x5EED0005
SOT, EOT = 49406, 49407


def load_mix(root: Path, name: str) -> dict:
    mix = json.loads((root / "benchmark" / "traffic" / f"{name}.json").read_text())
    kinds = pieces.names(root, "kinds")
    if mix.get("kind") not in kinds:
        raise ValueError(f"traffic {name}: kind {mix.get('kind')!r} has no "
                         f"benchmark/kinds/<kind>.py; known: {kinds}")
    return mix


def make_inputs(mix: dict, n_classes: int, seed: int, device) -> dict:
    """``canvas (B, S, S, 3)`` uint8, ``labels (B,)`` int64 and, where the mix
    has captions, ``captions (B, 77)`` int64, all on ``device``."""
    B, S = mix["batch"], mix["canvas"]
    gen = generator(seed, _DATA_STREAM, device)
    out = {
        "canvas": torch.randint(0, 256, (B, S, S, 3), generator=gen, device=device,
                                dtype=torch.uint8),
        "labels": torch.randint(0, n_classes, (B,), generator=gen, device=device),
    }
    if mix.get("captions"):
        lo, hi = mix["caption_tokens"]
        n = torch.randint(lo, hi + 1, (B,), generator=gen, device=device)
        words = torch.randint(1, SOT, (B, 77), generator=gen, device=device)
        pos = torch.arange(77, device=device)[None]
        ids = torch.where(pos <= n[:, None], words, torch.zeros_like(words))
        ids[:, 0] = SOT
        ids.scatter_(1, (n + 1)[:, None], EOT)
        out["captions"] = ids
    return out


def box_generator(seed: int, device) -> torch.Generator:
    return generator(seed, _BOX_STREAM, device)


def center_boxes(mix: dict, device):
    """The eval crop: the whole canvas, no flip."""
    B, S = mix["batch"], float(mix["canvas"])
    boxes = torch.zeros(B, 4, device=device)
    boxes[:, 2:] = S
    return boxes, torch.zeros(B, dtype=torch.bool, device=device)


def random_resized_boxes(gen: torch.Generator, mix: dict, trials: int = 10):
    """torchvision's RandomResizedCrop on canvas coordinates, drawn on the
    generator's device with no host round trip: ``trials`` candidates at
    once, the first that fits kept, the whole canvas where none does.
    Returns ``(boxes (B, 4) float32 (y0, x0, h, w), flips (B,) bool)``."""
    n, size = mix["batch"], float(mix["canvas"])
    (s_lo, s_hi), (r_lo, r_hi) = mix["scale"], mix["ratio"]
    dev = gen.device

    def uniform(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    area = size * size * uniform(n, trials, lo=s_lo, hi=s_hi)
    aspect = torch.exp(uniform(n, trials, lo=math.log(r_lo), hi=math.log(r_hi)))
    w = torch.round(torch.sqrt(area * aspect))
    h = torch.round(torch.sqrt(area / aspect))
    ok = (w > 0) & (w <= size) & (h > 0) & (h <= size)
    first = torch.argmax(ok.to(torch.int32), dim=1)
    found = ok.any(dim=1)
    rows = torch.arange(n, device=dev)
    w, h = w[rows, first], h[rows, first]
    y0 = torch.floor(uniform(n) * (size - h + 1.0))
    x0 = torch.floor(uniform(n) * (size - w + 1.0))
    full, zero = torch.full_like(h, size), torch.zeros_like(h)
    boxes = torch.stack([torch.where(found, y0, zero), torch.where(found, x0, zero),
                         torch.where(found, h, full), torch.where(found, w, full)], dim=1)
    return boxes.float(), uniform(n) < mix["flip"]


def eval_picks(mix: dict, seed: int) -> list:
    """The window's batches (0-based, from the window's start) that the
    seed picks for the comparison, among the first eight."""
    gen = generator(seed, _PICK_STREAM, "cpu")
    k = mix.get("eval_samples", 2)
    return sorted(torch.randperm(8, generator=gen)[:k].tolist())
