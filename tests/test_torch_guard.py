"""Guards of the PyTorch port: it imports nothing of JAX or of the JAX
package, and its entry points run on the card unless asked for the CPU."""

import ast
from pathlib import Path

import pytest
import torch

from federated_multi_modal_tpu_torch import flagship
from federated_multi_modal_tpu_torch.models import params
from federated_multi_modal_tpu_torch.trainers import coop, zsclip

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "optax", "federated_multi_modal_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((ROOT / "federated_multi_modal_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [
        f"{path.relative_to(ROOT)}: {mod}"
        for path in files for mod in _imported_modules(path)
        if mod.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad


def test_entry_points_refuse_to_run_on_the_cpu_unasked(monkeypatch):
    """``device=None`` means the card: without CUDA the entry points raise
    instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        flagship.build_maple_program(backbone="Tiny", depth=3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params.load_jax_params({"logit_scale": 0.0})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        flagship.example_batch(params.BACKBONE_CONFIGS["Tiny"], 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        coop.build_coop_program(backbone="Tiny", n_ctx=4)
    arch = params.BACKBONE_CONFIGS["Tiny"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        zsclip.zeroshot_text_features(params.init_clip_params(arch), arch, ["cat"],
                                      ["a photo of a {}."])


def test_resnet_towers_raise_until_ported():
    """The ModifiedResNet image towers (RN50, RN101) raise on every device
    until ``models/resnet.py`` is ported (ROADMAP module item 11)."""
    import dataclasses

    from federated_multi_modal_tpu_torch.models.clip_model import encode_image_auto

    rn50 = dataclasses.replace(params.CLIPConfig(), vision_layers=(3, 4, 6, 3))
    assert not rn50.is_vit
    with pytest.raises(NotImplementedError, match="models/resnet.py"):
        encode_image_auto({}, rn50, torch.zeros(1, 224, 224, 3), inference=True)
