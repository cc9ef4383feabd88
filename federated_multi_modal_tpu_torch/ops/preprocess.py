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
    mean = torch.tensor(mean, dtype=torch.float32, device=out.device)
    std = torch.tensor(std, dtype=torch.float32, device=out.device)
    return ((out - mean) / std).to(torch.bfloat16)


def center_boxes(n: int, canvas_size: int = DEFAULT_CANVAS, out_size: int = 224):
    """Eval boxes: the whole (already square) canvas, no flips."""
    boxes = np.tile(
        np.asarray([[0.0, 0.0, canvas_size, canvas_size]], np.float32), (n, 1))
    return boxes, np.zeros(n, bool)
