"""Guards of the PyTorch port: it imports nothing of JAX or of the JAX
package, and its entry points run on the card unless asked for the CPU."""

import ast
import re
import sys
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
    until ``models/resnet.py`` is ported (ROADMAP module item 6)."""
    import dataclasses

    from federated_multi_modal_tpu_torch.models.clip_model import encode_image_auto

    rn50 = dataclasses.replace(params.CLIPConfig(), vision_layers=(3, 4, 6, 3))
    assert not rn50.is_vit
    with pytest.raises(NotImplementedError, match="models/resnet.py"):
        encode_image_auto({}, rn50, torch.zeros(1, 224, 224, 3), inference=True)


def _cfg_for(trainer: str):
    from federated_multi_modal_tpu_torch.config import get_cfg_default

    cfg = get_cfg_default()
    cfg.TRAINER.NAME = trainer
    return cfg


def test_trainer_and_cli_refuse_to_run_on_the_cpu_unasked(monkeypatch, tmp_path):
    """``build_trainer`` and the command line's ``main`` run on the card:
    without CUDA they raise, unless asked for the CPU (``device="cpu"``,
    ``FMM_TPU_PLATFORM=cpu``)."""
    import federated_multi_modal_tpu_torch.trainers  # noqa: F401 - registers the trainers
    from federated_multi_modal_tpu_torch import train as port_cli
    from federated_multi_modal_tpu_torch.engine import build_trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "stdout", sys.stdout)  # main() tees it into log.txt
    monkeypatch.delenv("FMM_TPU_PLATFORM", raising=False)
    for trainer in ("MaPLe", "CoOp", "ZeroshotCLIP", "ZeroshotCLIP2"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_trainer(_cfg_for(trainer))
    args = port_cli.build_parser().parse_args(
        ["--trainer", "ZeroshotCLIP", "--output-dir", str(tmp_path), "--eval-only"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_cli.main(args)
    monkeypatch.setenv("FMM_TPU_PLATFORM", "cpu")
    assert port_cli.platform_device() == "cpu"


# a string naming the JAX package as a module or a path: its name not
# followed by the port's suffix, or its native library
_JAX_PATH = re.compile(r"federated_multi_modal_tpu(?!_torch)|libfmmtpu_io")


def _code_strings(path: Path):
    """The string constants of a Python file that are not docstrings."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docstrings = {id(node.value) for node in ast.walk(tree)
                  if isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant)}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docstrings):
            yield node.lineno, node.value


def test_port_names_no_file_of_the_jax_package():
    """No string of the port's code names the JAX package or its native
    library (a build step or a ``ctypes`` load that reached
    ``federated_multi_modal_tpu/native/imagecodec.cc`` or
    ``libfmmtpu_io.so``, which the import scan cannot see); neither does a
    rule of the port's Makefile."""
    package = ROOT / "federated_multi_modal_tpu_torch"
    bad = [f"{path.relative_to(ROOT)}:{line}: {text!r}"
           for path in sorted(package.rglob("*.py"))
           for line, text in _code_strings(path) if _JAX_PATH.search(text)]
    for makefile in package.rglob("Makefile"):
        bad += [f"{makefile.relative_to(ROOT)}: {ln!r}"
                for ln in makefile.read_text().splitlines()
                if not ln.lstrip().startswith("#") and _JAX_PATH.search(ln)]
    assert not bad, bad
    # the scan sees what it looks for
    assert _JAX_PATH.search("federated_multi_modal_tpu/native/libfmmtpu_io.so")
    assert not _JAX_PATH.search("federated_multi_modal_tpu_torch/build/")


def test_resnet_state_dict_raises_until_ported():
    """An OpenAI ModifiedResNet state dict raises as the random init does
    (ROADMAP module item 6)."""
    sd = {"visual.layer1.0.conv1.weight": torch.zeros(64, 64, 1, 1)}
    with pytest.raises(NotImplementedError, match="models/resnet.py"):
        params.infer_config_from_state_dict(sd)
    with pytest.raises(NotImplementedError, match="models/resnet.py"):
        params.init_clip_params(params.CLIPConfig(vision_layers=(3, 4, 6, 3)))
