"""On-device image preprocessing (port of
``federated_multi_modal_tpu/ops/preprocess.py``): the host only decodes
images onto a fixed uint8 canvas; crop-resize (bicubic with PIL-style
antialiasing, as two batched matmuls), horizontal flip and CLIP
normalization run on the device."""

from __future__ import annotations

import numpy as np
import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

DEFAULT_CANVAS = 256


def _cubic_kernel(t: torch.Tensor, a: float = -0.5) -> torch.Tensor:
    """Bicubic convolution kernel (a = -0.5, as PIL)."""
    at = t.abs()
    at2 = at * at
    at3 = at2 * at
    inner = (a + 2.0) * at3 - (a + 3.0) * at2 + 1.0
    outer = a * at3 - 5.0 * a * at2 + 8.0 * a * at - 4.0 * a
    zero = torch.zeros((), dtype=t.dtype, device=t.device)
    return torch.where(at <= 1.0, inner, torch.where(at < 2.0, outer, zero))


def _resample_matrix(canvas_size: int, out_size: int, start: torch.Tensor,
                     length: torch.Tensor) -> torch.Tensor:
    """Weights ``(B, out_size, canvas_size)`` resampling the window
    ``[start, start + length)`` of one axis to ``out_size`` samples, the
    kernel stretched by the downscale factor and clipped to the window
    (PIL's ``resize(box=...)``)."""
    start = start[:, None, None]
    length = length[:, None, None]
    scale = length / out_size
    kscale = torch.clamp(scale, min=1.0)
    o = torch.arange(out_size, dtype=torch.float32, device=start.device)
    centers = start + (o[None, :, None] + 0.5) * scale - 0.5
    pos = torch.arange(canvas_size, dtype=torch.float32, device=start.device)
    w = _cubic_kernel((pos[None, None, :] - centers) / kscale)
    inside = (pos + 0.5 >= start) & (pos + 0.5 <= start + length)
    w = w * inside.to(w.dtype)
    return w / w.sum(dim=2, keepdim=True)


def crop_resize_flip_normalize(canvas: torch.Tensor, boxes: torch.Tensor,
                               flips: torch.Tensor, out_size: int = 224,
                               mean=CLIP_MEAN, std=CLIP_STD) -> torch.Tensor:
    """``canvas (B, S, S, 3)`` uint8, ``boxes (B, 4)`` fp32 ``(y0, x0, h,
    w)`` in canvas pixels, ``flips (B,)`` bool -> ``(B, out_size, out_size,
    3)`` bf16 CLIP-normalized images."""
    S = canvas.shape[1]
    imgs = canvas.float() * (1.0 / 255.0)
    boxes = boxes.float()
    wy = _resample_matrix(S, out_size, boxes[:, 0], boxes[:, 2])  # (B, O, S)
    wx = _resample_matrix(S, out_size, boxes[:, 1], boxes[:, 3])
    tmp = torch.einsum("bos,bshc->bohc", wy, imgs)  # rows
    out = torch.einsum("bwt,botc->bowc", wx, tmp)  # columns
    out = torch.where(flips[:, None, None, None], out.flip(2), out)
    return ((out - _channel_constant(mean, out.device))
            / _channel_constant(std, out.device)).to(torch.bfloat16)


def _channel_constant(values, device) -> torch.Tensor:
    """``values`` as an fp32 vector made on ``device`` by fill kernels (the
    same roundings as ``torch.tensor(values, dtype=torch.float32)``): no
    host-to-device copy, which a step captured in a CUDA graph may not
    hold."""
    return torch.stack([torch.full((), v, dtype=torch.float32, device=device) for v in values])


def center_boxes(n: int, canvas_size: int = DEFAULT_CANVAS, out_size: int = 224):
    """Eval boxes: the whole (already square) canvas, no flips."""
    boxes = np.tile(
        np.asarray([[0.0, 0.0, canvas_size, canvas_size]], np.float32), (n, 1))
    return boxes, np.zeros(n, bool)


# -- crop-parameter sampling (torchvision RandomResizedCrop's procedure on
# -- canvas coordinates) ------------------------------------------------------


def sample_rrc_boxes(rng: np.random.Generator, n: int,
                     canvas_size: int = DEFAULT_CANVAS, scale=(0.08, 1.0),
                     ratio=(3.0 / 4.0, 4.0 / 3.0)):
    """Host-side sampling of ``(n, 4)`` random-resized-crop boxes ``(y0,
    x0, h, w)`` and ``(n,)`` flip flags, as the JAX package's numpy sampler
    draws them (a copy: the same draws from the same generator)."""
    boxes = np.empty((n, 4), np.float32)
    area = canvas_size * canvas_size
    log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
    for i in range(n):
        for _ in range(10):
            target_area = area * rng.uniform(scale[0], scale[1])
            aspect = np.exp(rng.uniform(log_ratio[0], log_ratio[1]))
            w = int(round(np.sqrt(target_area * aspect)))
            h = int(round(np.sqrt(target_area / aspect)))
            if 0 < w <= canvas_size and 0 < h <= canvas_size:
                y0 = rng.integers(0, canvas_size - h + 1)
                x0 = rng.integers(0, canvas_size - w + 1)
                boxes[i] = (y0, x0, h, w)
                break
        else:  # centre fallback (torchvision semantics)
            boxes[i] = (0, 0, canvas_size, canvas_size)
    flips = rng.random(n) < 0.5
    return boxes, flips.astype(bool)


def sample_rrc_boxes_torch(generator: torch.Generator, n: int,
                           canvas_size: int = DEFAULT_CANVAS, scale=(0.08, 1.0),
                           ratio=(3.0 / 4.0, 4.0 / 3.0), trials: int = 10):
    """Device-side counterpart of :func:`sample_rrc_boxes` (the JAX
    package's ``sample_rrc_boxes_jax``): all ``trials`` candidates drawn at
    once on the generator's device and the first in-bounds one kept, so
    sampling needs no host round trip. The same distribution, not the same
    numbers (a ``torch.Generator`` is not ``jax.random``). Returns ``(boxes
    (n, 4) fp32 [y0, x0, h, w], flips (n,) bool)``."""
    device = generator.device

    def uniform(*shape, lo=0.0, hi=1.0):
        u = torch.rand(shape, generator=generator, device=device)
        return lo + (hi - lo) * u

    area = float(canvas_size * canvas_size)
    target_area = area * uniform(n, trials, lo=scale[0], hi=scale[1])
    aspect = torch.exp(uniform(n, trials, lo=float(np.log(ratio[0])),
                               hi=float(np.log(ratio[1]))))
    w = torch.round(torch.sqrt(target_area * aspect))
    h = torch.round(torch.sqrt(target_area / aspect))
    valid = (w > 0) & (w <= canvas_size) & (h > 0) & (h <= canvas_size)
    first = torch.argmax(valid.to(torch.int32), dim=1)  # the first accepted trial
    any_valid = valid.any(dim=1)
    rows = torch.arange(n, device=device)
    w_sel, h_sel = w[rows, first], h[rows, first]
    y0 = torch.floor(uniform(n) * (canvas_size - h_sel + 1.0))
    x0 = torch.floor(uniform(n) * (canvas_size - w_sel + 1.0))
    full = torch.full_like(h_sel, float(canvas_size))
    zero = torch.zeros_like(h_sel)
    boxes = torch.stack([torch.where(any_valid, y0, zero), torch.where(any_valid, x0, zero),
                         torch.where(any_valid, h_sel, full),
                         torch.where(any_valid, w_sel, full)], dim=1)
    flips = uniform(n) < 0.5
    return boxes.float(), flips
