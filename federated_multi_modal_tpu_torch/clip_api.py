"""OpenAI-CLIP-style public API of the port (counterpart of
``federated_multi_modal_tpu/clip_api.py``): ``available_models()``,
``load()``, ``tokenize()`` and the checkpoint download with its SHA-256
check (``clip/clip.py``'s surface). A download needs network egress and is
tried only when the file is not in ``download_root`` already; air-gapped
users pass ``load`` the path of a local ``.pt``.
"""

from __future__ import annotations

import hashlib
import os
import urllib.request
import warnings

from federated_multi_modal_tpu_torch.device import resolve_device
from federated_multi_modal_tpu_torch.engine.tree import to_device
from federated_multi_modal_tpu_torch.models.params import (
    BACKBONE_CONFIGS,
    convert_torch_state_dict,
    infer_config_from_state_dict,
    init_clip_params,
    load_torch_state_dict,
)
from federated_multi_modal_tpu_torch.tokenizer import tokenize  # noqa: F401

# OpenAI's checkpoints; the SHA-256 is the URL's second-to-last segment.
_MODELS = {
    "RN50": "https://openaipublic.azureedge.net/clip/models/afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762/RN50.pt",
    "RN101": "https://openaipublic.azureedge.net/clip/models/8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599/RN101.pt",
    "RN50x4": "https://openaipublic.azureedge.net/clip/models/7e526bd135e493cef0776de27d5f42653e6b4c8bf9e0f653bb11773263205fdd/RN50x4.pt",
    "RN50x16": "https://openaipublic.azureedge.net/clip/models/52378b407f34354e150460fe41077663dd5b39c54cd0bfd2b27167a4a06ec9aa/RN50x16.pt",
    "ViT-B/32": "https://openaipublic.azureedge.net/clip/models/40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/ViT-B-32.pt",
    "ViT-B/16": "https://openaipublic.azureedge.net/clip/models/5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f/ViT-B-16.pt",
    "ViT-L/14": "https://openaipublic.azureedge.net/clip/models/b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca1737a03836/ViT-L-14.pt",
}


def available_models() -> list:
    return list(_MODELS)


def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _download(url: str, root: str = None) -> str:
    """The checkpoint at ``url`` in ``root`` (``~/.cache/clip`` when
    ``None``): the cached file when its SHA-256 matches, else downloaded
    and checked."""
    root = root or os.path.expanduser("~/.cache/clip")
    os.makedirs(root, exist_ok=True)
    expected_sha256 = url.split("/")[-2]
    target = os.path.join(root, os.path.basename(url))

    if os.path.isfile(target):
        if _sha256(target) == expected_sha256:
            return target
        warnings.warn(f"{target} exists but the SHA256 does not match; re-downloading")

    with urllib.request.urlopen(url) as source, open(target, "wb") as output:
        while True:
            buf = source.read(8192)
            if not buf:
                break
            output.write(buf)

    if _sha256(target) != expected_sha256:
        raise RuntimeError("Model has been downloaded but the SHA256 does not match")
    return target


def _load_torch(path: str):
    sd = load_torch_state_dict(path)
    arch = infer_config_from_state_dict(sd)
    return arch, convert_torch_state_dict(sd, arch)


def load(name: str, download_root: str = None, allow_random: bool = True, device=None):
    """``(CLIPConfig, params)`` for a model name or a local path, the
    parameters on ``device`` (``None`` means ``"cuda"``):

    * a local ``.pt``/``.pth`` file is converted;
    * a known model name is downloaded (or read from ``download_root``'s
      cache) and converted; only where that fails, and with
      ``allow_random``, a random CLIP init takes its place, with a warning
      (a conversion failure on a file obtained surfaces);
    * another name of the backbone table gives a random init with
      ``allow_random``; anything else raises ``RuntimeError``.
    """
    device = resolve_device(device)
    if os.path.isfile(name):
        arch, params = _load_torch(name)
    elif name in _MODELS:
        try:
            path = _download(_MODELS[name], download_root)
        except Exception as e:  # no egress and no cache
            if not allow_random:
                raise
            warnings.warn(f"Could not obtain weights for {name} ({e}); using random "
                          "CLIP-initialized parameters.")
            arch = BACKBONE_CONFIGS[name]
            params = init_clip_params(arch)
        else:
            arch, params = _load_torch(path)
    elif name in BACKBONE_CONFIGS and allow_random:
        arch = BACKBONE_CONFIGS[name]
        params = init_clip_params(arch)
    else:
        raise RuntimeError(f"Model {name} not found; available models = {available_models()}")
    return arch, to_device(params, device)
