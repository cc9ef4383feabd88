"""Input transforms (port of ``federated_multi_modal_tpu/data/transforms.py``
over the port's ``ops/preprocess.py``; Pillow is needed only where a file
is decoded without the native codec).

Two pipelines, selected by ``cfg.INPUT.PIPELINE``:

* ``"device"`` (default, TPU-first): the host only decodes to a fixed
  square uint8 canvas; random-resized-crop parameters are sampled on host
  and the bicubic crop-resize + flip + CLIP-normalize run fused on device
  (``ops/preprocess.py``).  This is the throughput path demanded by the
  build's north star.
* ``"host"``: the torchvision-equivalent PIL pipeline
  (``random_resized_crop`` + ``random_flip`` + ``normalize`` for train;
  Resize(shorter=224, bicubic) + CenterCrop for eval — reference cfg
  ``configs/trainers/MaPLe/vit_b16_c2_ep5_batch4_2ctx.yaml:8-14`` and
  ``clip/clip.py:71-78``), producing normalized fp32 on host.  Exact
  parity path, slow on few-core hosts.
"""

from __future__ import annotations

import numpy as np

try:
    from PIL import Image

    _HAS_PIL = True
except ImportError:  # pragma: no cover
    _HAS_PIL = False

from federated_multi_modal_tpu_torch.ops.preprocess import (
    DEFAULT_CANVAS,
    center_boxes,
    sample_rrc_boxes,
)

_INTERP = {}
if _HAS_PIL:
    _INTERP = {
        "bilinear": Image.BILINEAR,
        "bicubic": Image.BICUBIC,
        "nearest": Image.NEAREST,
    }


def _require_pil():
    if not _HAS_PIL:
        raise ImportError(
            "Pillow is needed to decode here: for INPUT.PIPELINE 'host', and for "
            "'device' where the native codec is unavailable or fails on a file")


def _open_rgb(impath: str, retries: int = 3, delay: float = 0.1):
    """Open an image, retrying transient IO errors.  Dassl's ``read_image``
    retries *forever*; this bounds it (documented deviation: an image that
    never opens should fail the run, not hang it)."""
    import time

    last = None
    for attempt in range(retries):
        try:
            return Image.open(impath).convert("RGB")
        except OSError as e:
            last = e
            if attempt < retries - 1:
                time.sleep(delay)
    raise last


class DeviceTransform:
    """Host half of the device pipeline: decode -> square canvas uint8.

    Decodes through the native C++ codec (libjpeg DCT-prescale + libpng +
    PIL-equivalent resampling, ``native/imagecodec.cc``) when available,
    falling back to PIL per file — the TPU-native replacement for the
    reference's 8 PIL dataloader worker processes
    (``trainers/client_datamanager.py:65-103``).
    """

    mode = "device"

    def __init__(self, cfg, is_train: bool):
        self.is_train = is_train
        self.canvas = getattr(cfg.INPUT, "CANVAS_SIZE", DEFAULT_CANVAS)
        self.out_size = cfg.INPUT.SIZE[0]
        self.interp_name = cfg.INPUT.INTERPOLATION
        self.scale = getattr(cfg.INPUT, "RRCROP_SCALE", (0.08, 1.0))
        # "shorter_crop" (default) builds an aspect-preserving canvas
        # (Resize(shorter) + CenterCrop — the reference's eval geometry)
        # for EVAL only; training canvases always keep the full frame
        # (squashed into the square) so the on-device RandomResizedCrop can
        # sample anywhere in the original image, like the reference's
        # torchvision RRC over the full frame — a center-cropped train
        # canvas could never show a crop the off-center band of a
        # non-square photo.  "squash" uses the full frame for eval too.
        self.crop_square = (
            getattr(cfg.INPUT, "CANVAS_MODE", "shorter_crop") != "squash"
            and not is_train
        )
        self.native = bool(getattr(cfg.INPUT, "NATIVE_DECODE", True))
        if self.native:
            from federated_multi_modal_tpu_torch import native as _native

            self.native = (
                _native.available() and self.interp_name in _native.INTERP
            )

    def decode_pil(self, impath: str) -> np.ndarray:
        _require_pil()
        img = _open_rgb(impath)
        if self.crop_square and img.width != img.height:
            side = min(img.width, img.height)
            x0 = (img.width - side) // 2
            y0 = (img.height - side) // 2
            img = img.crop((x0, y0, x0 + side, y0 + side))
        interp = _INTERP.get(self.interp_name, Image.BICUBIC)
        img = img.resize((self.canvas, self.canvas), interp)
        return np.asarray(img, dtype=np.uint8)

    def __call__(self, impath: str) -> np.ndarray:
        if self.native:
            from federated_multi_modal_tpu_torch import native as _native

            frame = _native.decode_to_canvas(
                impath, self.canvas, self.interp_name,
                crop_square=self.crop_square,
            )
            if frame is not None:
                return frame
        return self.decode_pil(impath)

    def sample_params(self, rng: np.random.Generator, n: int):
        if self.is_train:
            return sample_rrc_boxes(rng, n, self.canvas, scale=self.scale)
        return center_boxes(n, self.canvas, self.out_size)


class HostTransform:
    """Full PIL pipeline producing CLIP-normalized fp32 HWC arrays."""

    mode = "host"

    def __init__(self, cfg, is_train: bool):
        _require_pil()
        self.is_train = is_train
        self.size = cfg.INPUT.SIZE[0]
        self.interp = _INTERP.get(cfg.INPUT.INTERPOLATION, Image.BICUBIC)
        self.mean = np.asarray(cfg.INPUT.PIXEL_MEAN, np.float32)
        self.std = np.asarray(cfg.INPUT.PIXEL_STD, np.float32)
        self.scale = getattr(cfg.INPUT, "RRCROP_SCALE", (0.08, 1.0))
        self.transforms = tuple(cfg.INPUT.TRANSFORMS) or (
            "random_resized_crop",
            "random_flip",
            "normalize",
        )
        self.rng = np.random.default_rng()

    # torchvision RandomResizedCrop's sampling, on the original image
    def _rrc(self, img):
        W, H = img.size
        area = H * W
        ratio = (3.0 / 4.0, 4.0 / 3.0)
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        for _ in range(10):
            target_area = area * self.rng.uniform(*self.scale)
            aspect = np.exp(self.rng.uniform(*log_ratio))
            w = int(round(np.sqrt(target_area * aspect)))
            h = int(round(np.sqrt(target_area / aspect)))
            if 0 < w <= W and 0 < h <= H:
                x0 = int(self.rng.integers(0, W - w + 1))
                y0 = int(self.rng.integers(0, H - h + 1))
                box = (x0, y0, x0 + w, y0 + h)
                return img.resize((self.size, self.size), self.interp, box=box)
        # fallback: center crop of the shorter side
        side = min(H, W)
        x0 = (W - side) // 2
        y0 = (H - side) // 2
        return img.resize(
            (self.size, self.size), self.interp, box=(x0, y0, x0 + side, y0 + side)
        )

    def _resize_center_crop(self, img):
        W, H = img.size
        short = min(W, H)
        new_w = int(round(W * self.size / short))
        new_h = int(round(H * self.size / short))
        img = img.resize((new_w, new_h), self.interp)
        x0 = (new_w - self.size) // 2
        y0 = (new_h - self.size) // 2
        return img.crop((x0, y0, x0 + self.size, y0 + self.size))

    def __call__(self, impath: str) -> np.ndarray:
        img = _open_rgb(impath)
        if self.is_train:
            if "random_resized_crop" in self.transforms:
                img = self._rrc(img)
            else:
                img = self._resize_center_crop(img)
            if "random_flip" in self.transforms and self.rng.random() < 0.5:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
        else:
            img = self._resize_center_crop(img)
        x = np.asarray(img, np.float32) / 255.0
        x = (x - self.mean) / self.std
        return x


def build_transform(cfg, is_train: bool = True):
    """Factory matching Dassl's ``build_transform(cfg, is_train)`` surface
    (called at reference ``trainers/client_datamanager.py:30-34``).
    ``INPUT.NO_TRANSFORM`` disables augmentation (Dassl semantics): train
    uses the deterministic eval transform (resize + center crop +
    normalize)."""
    if getattr(cfg.INPUT, "NO_TRANSFORM", False):
        is_train = False
    pipeline = getattr(cfg.INPUT, "PIPELINE", "device")
    if pipeline == "host":
        return HostTransform(cfg, is_train)
    return DeviceTransform(cfg, is_train)
