"""The port's configuration (``federated_multi_modal_tpu_torch/config``) and
its command line's ``setup_cfg`` against the JAX package's: the defaults
key for key, the merge order of ``train.py``, and every yaml of
``configs/`` merged into both."""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from federated_multi_modal_tpu.config import get_cfg_default as jax_defaults
from federated_multi_modal_tpu_torch import train as port_cli
from federated_multi_modal_tpu_torch.config import CfgNode, get_cfg_default

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))  # the repository's train.py
import train as jax_cli  # noqa: E402

YAMLS = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "configs").rglob("*.yaml"))


def _typed(node):
    """A config as nested dicts of ``(type name, value)`` leaves, so that a
    tuple and a list of the same items differ."""
    if isinstance(node, dict):
        return {k: _typed(v) for k, v in node.items()}
    return (type(node).__name__, node)


def _args(**kw):
    base = dict(
        root="", output_dir="", resume="", seed=0, source_domains=None,
        target_domains=None, transforms=None, trainer="", backbone="",
        head="", eval_only=False, model_dir="", load_epoch=None,
        no_train=False, opts=[], config_file="", dataset_config_file="",
    )
    base.update(kw)
    return SimpleNamespace(**base)


def test_defaults_equal_key_for_key():
    port, ref = get_cfg_default(), jax_defaults()
    assert _typed(port) == _typed(ref)
    assert str(port) == str(ref)
    assert port.dump() == ref.dump()


def test_setup_cfg_merge_order(tmp_path):
    """Dataset yaml, then trainer yaml, then the flags, then the opts
    (``tests/test_cli.py``'s case), equal to the JAX package's result."""
    ds = tmp_path / "ds.yaml"
    ds.write_text("DATASET:\n  NAME: 'EuroSAT'\nOPTIM:\n  LR: 0.1\n")
    tr = tmp_path / "tr.yaml"
    tr.write_text("OPTIM:\n  LR: 0.2\n  MAX_EPOCH: 7\n")
    args = _args(dataset_config_file=str(ds), config_file=str(tr), trainer="MaPLe",
                 root="/data", seed=3, backbone="ViT-B/32",
                 opts=["OPTIM.LR", "0.3", "INPUT.SIZE", "(32, 32)"])
    cfg = port_cli.setup_cfg(args)
    assert cfg.OPTIM.LR == 0.3
    assert cfg.OPTIM.MAX_EPOCH == 7
    assert cfg.DATASET.NAME == "EuroSAT"
    assert cfg.TRAINER.NAME == "MaPLe"
    assert cfg.DATASET.ROOT == "/data"
    assert cfg.SEED == 3
    assert cfg.MODEL.BACKBONE.NAME == "ViT-B/32"
    assert cfg.INPUT.SIZE == (32, 32)
    assert cfg.is_frozen()
    assert _typed(cfg) == _typed(jax_cli.setup_cfg(args))


def test_parser_is_train_py_s():
    """The port's parser takes ``train.py``'s flags and gives the same
    namespace on the same argv."""
    argv = ["--root", "/d", "--seed", "2", "--trainer", "CoOp", "--config-file", "a.yaml",
            "--dataset-config-file", "b.yaml", "--output-dir", "o", "--eval-only",
            "--model-dir", "m", "--load-epoch", "3", "--source-domains", "x", "y",
            "OPTIM.LR", "0.1"]
    from test_torch_cli import _jax_parser

    args = port_cli.build_parser().parse_args(argv)
    assert vars(args) == vars(_jax_parser().parse_args(argv))


def test_unknown_opts_key_raises():
    with pytest.raises(KeyError, match="Non-existent config key"):
        port_cli.setup_cfg(_args(opts=["OPTIM.NOPE", "1"]))


@pytest.mark.parametrize("yaml_path", YAMLS)
def test_every_yaml_merges_equal(yaml_path):
    """Each yaml of ``configs/`` merged into the defaults of both packages,
    as a trainer file and after ``configs/datasets/synthetic.yaml``."""
    port, ref = get_cfg_default(), jax_defaults()
    for cfg in (port, ref):
        cfg.merge_from_file(str(ROOT / "configs" / "datasets" / "synthetic.yaml"))
        cfg.merge_from_file(str(ROOT / yaml_path))
    assert _typed(port) == _typed(ref)
    assert isinstance(port, CfgNode)
