"""The port's command line (``python -m federated_multi_modal_tpu_torch.train``)
against the JAX package's ``train.py``, each ``main`` run in process on the
Synthetic dataset and the Tiny backbone, on the CPU.

Both packages draw their random init from other generators, so both runs
are given the same weights: ``MODEL.BACKBONE.WEIGHTS_PATH``, a Tiny CLIP in
OpenAI's state-dict layout built here from a seed and ``torch.save``d, and
``MODEL.INIT_WEIGHTS``, the JAX trainer's initial trainable tree saved with
the JAX package's ``save_checkpoint``. Per-epoch mean losses are read from
each trainer's ``run_epoch``, the final accuracy from ``test()``.

Each JAX trainer sets module globals of the JAX package when it is built,
and each port trainer the port's (the attention implementation, the text
packing); ``sys.stdout`` is replaced by each run's ``log.txt`` tee. The
fixtures put all of them back afterwards.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import federated_multi_modal_tpu.models.clip_model as jax_clip
import federated_multi_modal_tpu.ops.primitives as jax_prim
import federated_multi_modal_tpu.trainers  # noqa: F401 - registers the trainers
from federated_multi_modal_tpu.engine.checkpoint import flatten_params as jax_flatten
from federated_multi_modal_tpu.engine.checkpoint import save_checkpoint as jax_save
from federated_multi_modal_tpu_torch import train as port_cli
from federated_multi_modal_tpu_torch.engine import trainer as port_trainer
from federated_multi_modal_tpu_torch.models import clip_model as port_clip
from federated_multi_modal_tpu_torch.models import params as port_params
from federated_multi_modal_tpu_torch.ops import primitives as port_prim

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))  # the repository's train.py
import train as jax_cli  # noqa: E402

MAPLE_YAML = "configs/trainers/MaPLe/vit_b16_c2_ep5_batch4_2ctx.yaml"
COOP_YAML = "configs/trainers/CoOp/vit_b16.yaml"
SYNTHETIC_YAML = "configs/datasets/synthetic.yaml"
TINY = ["MODEL.BACKBONE.NAME", "Tiny", "INPUT.SIZE", "(32, 32)", "INPUT.CANVAS_SIZE", "40",
        "DATALOADER.TEST.BATCH_SIZE", "8", "TPU.DATA_PARALLEL", "False", "VERBOSE", "False"]
# fp32 (TRAINER.*.PREC fp32): the per-epoch mean losses read at most 5e-8
# relative against a limit of 1e-4 (the arithmetic is the same; only the
# order of sums differs)
FP32_LOSS_RTOL = 1e-4
# the bf16 policy: tests/test_torch_train.py's BF16_ERROR_RATIO, the port no
# further from the fp32 losses than twice the JAX package's distance (it
# reads 1.62 and 1.46 of it on MaPLe's two epochs)
BF16_ERROR_RATIO = 2.0


def _argv(trainer, config_file, out_dir, root, opts, seed=1, extra=()):
    argv = ["--root", str(root), "--seed", str(seed), "--trainer", trainer,
            "--dataset-config-file", str(ROOT / SYNTHETIC_YAML),
            "--output-dir", str(out_dir), *extra]
    if config_file:
        argv += ["--config-file", str(ROOT / config_file)]
    return argv + TINY + list(opts)


def _jax_parser():
    """``train.py``'s parser, which it builds inline under ``__main__``."""
    source = (ROOT / "train.py").read_text()
    body = source.split('if __name__ == "__main__":\n', 1)[1]
    body = body.replace("    main(parser.parse_args())", "    return parser")
    namespace = {"argparse": __import__("argparse")}
    exec("def build_parser():\n" + body, namespace)
    return namespace["build_parser"]()


def _recorded(monkeypatch, trainer_cls, record):
    """Record each ``run_epoch``'s mean loss and each ``test()``'s result of
    instances of ``trainer_cls``."""
    run_epoch, test = trainer_cls.run_epoch, trainer_cls.test

    def run_epoch_rec(self, *args, **kwargs):
        loss = run_epoch(self, *args, **kwargs)
        record.setdefault("losses", []).append(float(loss))
        return loss

    def test_rec(self, *args, **kwargs):
        result = test(self, *args, **kwargs)
        record.setdefault("tests", []).append(result)
        return result

    monkeypatch.setattr(trainer_cls, "run_epoch", run_epoch_rec)
    monkeypatch.setattr(trainer_cls, "test", test_rec)


def run_jax(argv):
    """The JAX package's ``train.py`` ``main`` on ``argv``: its recorded
    losses and tests."""
    from federated_multi_modal_tpu.engine.registry import TRAINER_REGISTRY

    record = {}
    args = _jax_parser().parse_args(argv)
    name = args.trainer
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "stdout", sys.stdout)
        for module, attr in ((jax_prim, "_ATTENTION_IMPL"),
                             (jax_prim, "_VISION_ATTN_WGRAD_BLOCKS"),
                             (jax_clip, "_TEXT_PACK_DEFAULT")):
            mp.setattr(module, attr, getattr(module, attr))
        _recorded(mp, TRAINER_REGISTRY.get(name), record)
        jax_cli.main(args)
    return record


def run_port(argv):
    """The port's ``main`` on ``argv``, on the CPU: its recorded losses and
    tests, and the trainer."""
    from federated_multi_modal_tpu_torch.engine.registry import TRAINER_REGISTRY

    record = {}
    args = port_cli.build_parser().parse_args(argv)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "stdout", sys.stdout)
        mp.setenv("FMM_TPU_PLATFORM", "cpu")
        for module, attr in ((port_prim, "_ATTENTION_IMPL"), (port_clip, "_TEXT_PACK_DEFAULT")):
            mp.setattr(module, attr, getattr(module, attr))
        _recorded(mp, TRAINER_REGISTRY.get(args.trainer), record)
        record["trainer"] = port_cli.main(args)
    return record


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A Tiny CLIP in OpenAI's layout (fp16, as OpenAI ships it), saved with
    ``torch.save``."""
    d = tmp_path_factory.mktemp("weights")
    arch = port_params.BACKBONE_CONFIGS["Tiny"]
    params = port_params.init_clip_params(arch, torch.Generator().manual_seed(11),
                                          dtype_policy=False)
    path = d / "tiny_openai.pt"
    torch.save(port_params.export_openai_state_dict(params, arch), path)
    return path


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return tmp_path_factory.mktemp("data")


def _init_weights(tmp_dir, data_root, weights, trainer, config_file, opts):
    """The JAX trainer's initial trainable tree under these settings, saved
    by the JAX package's ``save_checkpoint``."""
    from federated_multi_modal_tpu.engine import build_trainer

    args = _jax_parser().parse_args(
        _argv(trainer, config_file, tmp_dir / "init-run", data_root,
              ["MODEL.BACKBONE.WEIGHTS_PATH", str(weights), *opts]))
    cfg = jax_cli.setup_cfg(args)
    with pytest.MonkeyPatch.context() as mp:
        for module, attr in ((jax_prim, "_ATTENTION_IMPL"),
                             (jax_prim, "_VISION_ATTN_WGRAD_BLOCKS"),
                             (jax_clip, "_TEXT_PACK_DEFAULT")):
            mp.setattr(module, attr, getattr(module, attr))
        trainer_obj = build_trainer(cfg)
    jax_save({"epoch": 0, "state_dict": jax_flatten(trainer_obj.trainable)},
             str(tmp_dir / "init"), model_name="init.pth.tar")
    return tmp_dir / "init" / "init.pth.tar"


MAPLE_OPTS = ["TRAINER.MAPLE.PROMPT_DEPTH", "3", "OPTIM.MAX_EPOCH", "2"]
COOP_OPTS = ["TRAINER.COOP.N_CTX", "4", "OPTIM.MAX_EPOCH", "1",
             "DATALOADER.TRAIN_X.BATCH_SIZE", "4"]


@pytest.fixture(scope="module")
def maple(tmp_path_factory, weights, data_root):
    """MaPLe's initial trainable tree from the JAX trainer, and the JAX
    package's fp32 run on it (each output directory is ``<name>/seed1``, as
    ``tools/parse_test_res.py`` reads)."""
    d = tmp_path_factory.mktemp("maple")
    opts = MAPLE_OPTS + ["TRAINER.MAPLE.PREC", "fp32"]
    init = _init_weights(d, data_root, weights, "MaPLe", MAPLE_YAML, opts)
    common = ["MODEL.BACKBONE.WEIGHTS_PATH", str(weights), "MODEL.INIT_WEIGHTS", str(init)]
    jax_fp32 = run_jax(_argv("MaPLe", MAPLE_YAML, d / "jax" / "seed1", data_root, opts + common))
    return {"dir": d, "common": common, "jax_fp32": jax_fp32}


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref) / np.abs(ref)


def _accuracy(record):
    return [r["accuracy"] for r in record["tests"]]


def test_maple_cli_fp32_matches_jax(maple, data_root):
    """Two epochs (the constant warmup, then cosine) under ``PREC fp32``:
    each epoch's mean loss within ``FP32_LOSS_RTOL`` and the final accuracy
    equal; the checkpoint of epoch 2 and ``log.txt`` written."""
    opts = MAPLE_OPTS + ["TRAINER.MAPLE.PREC", "fp32"] + maple["common"]
    out = maple["dir"] / "port" / "seed1"
    port = run_port(_argv("MaPLe", MAPLE_YAML, out, data_root, opts))
    ref = maple["jax_fp32"]
    assert len(port["losses"]) == len(ref["losses"]) == 2
    assert np.all(_rel(port["losses"], ref["losses"]) <= FP32_LOSS_RTOL), (
        port["losses"], ref["losses"])
    assert _accuracy(port) == _accuracy(ref)
    assert (out / "MultiModalPromptLearner" / "model.pth.tar-2").is_file()
    assert "Finished training" in (out / "log.txt").read_text()


def test_maple_cli_bf16_as_close_as_jax(maple, data_root):
    """The configuration's ``PREC fp16`` (the bf16 policy): each package's
    per-epoch losses against the JAX package's fp32 ones; the port's
    distance at most ``BF16_ERROR_RATIO`` times the JAX package's."""
    opts = MAPLE_OPTS + maple["common"]
    d = maple["dir"]
    jax_bf16 = run_jax(_argv("MaPLe", MAPLE_YAML, d / "jax-bf16" / "seed1", data_root, opts))
    port = run_port(_argv("MaPLe", MAPLE_YAML, d / "port-bf16" / "seed1", data_root, opts))
    exact = np.asarray(maple["jax_fp32"]["losses"])
    jax_err = np.abs(np.asarray(jax_bf16["losses"]) - exact)
    port_err = np.abs(np.asarray(port["losses"]) - exact)
    assert np.all(port_err <= BF16_ERROR_RATIO * jax_err), (port_err, jax_err)
    assert _accuracy(port) == _accuracy(jax_bf16)


def test_coop_cli_fp32_matches_jax(tmp_path, weights, data_root):
    """CoOp, one epoch of four steps (batch 4: the configuration's 32 is
    more than Synthetic's 16 training images, and the loader drops the
    short batch), ``PREC fp32``, its context from the JAX trainer."""
    opts = COOP_OPTS + ["TRAINER.COOP.PREC", "fp32"]
    init = _init_weights(tmp_path, data_root, weights, "CoOp", COOP_YAML, opts)
    opts += ["MODEL.BACKBONE.WEIGHTS_PATH", str(weights), "MODEL.INIT_WEIGHTS", str(init)]
    ref = run_jax(_argv("CoOp", COOP_YAML, tmp_path / "jax", data_root, opts))
    port = run_port(_argv("CoOp", COOP_YAML, tmp_path / "port", data_root, opts))
    assert len(port["losses"]) == len(ref["losses"]) == 1
    assert np.all(_rel(port["losses"], ref["losses"]) <= FP32_LOSS_RTOL), (
        port["losses"], ref["losses"])
    assert _accuracy(port) == _accuracy(ref)
    assert (tmp_path / "port" / "prompt_learner" / "model.pth.tar-1").is_file()


@pytest.mark.parametrize("trainer", ["ZeroshotCLIP", "ZeroshotCLIP2"])
def test_zeroshot_cli_matches_jax(trainer, tmp_path, weights, data_root):
    """``--eval-only`` zero-shot CLIP on the same OpenAI-format weights, as
    ``train.py`` runs it (the bf16 policy): the same accuracy, and the same
    ``* accuracy`` line in each ``log.txt``."""
    opts = ["MODEL.BACKBONE.WEIGHTS_PATH", str(weights)]
    extra = ("--eval-only",)
    ref = run_jax(_argv(trainer, COOP_YAML, tmp_path / "jax", data_root, opts, extra=extra))
    port = run_port(_argv(trainer, COOP_YAML, tmp_path / "port", data_root, opts, extra=extra))
    assert _accuracy(port) == _accuracy(ref)
    lines = [re.findall(r"\* accuracy: .*%", (tmp_path / name / "log.txt").read_text())
             for name in ("jax", "port")]
    assert lines[0] == lines[1] and lines[0]


def test_eval_only_reload_and_resume(maple, data_root):
    """The port's ``--eval-only --model-dir --load-epoch 2`` on its own fp32
    run reads that run's final accuracy; ``--resume`` on it with
    ``OPTIM.MAX_EPOCH 3`` restores the weights and the optimizer state
    (the LR and the momentum) and trains epoch 3 only."""
    opts = MAPLE_OPTS + ["TRAINER.MAPLE.PREC", "fp32"] + maple["common"]
    out = maple["dir"] / "port-reload" / "seed1"
    trained = run_port(_argv("MaPLe", MAPLE_YAML, out, data_root, opts))
    evaluated = run_port(_argv("MaPLe", MAPLE_YAML, maple["dir"] / "eval", data_root, opts,
                               extra=("--eval-only", "--model-dir", str(out),
                                      "--load-epoch", "2")))
    assert _accuracy(evaluated) == _accuracy(trained)[-1:]
    np.testing.assert_array_equal(
        _flat(evaluated["trainer"].trainable)["prompt_learner.ctx"],
        _flat(trained["trainer"].trainable)["prompt_learner.ctx"])

    opts3 = [*opts]
    opts3[opts3.index("OPTIM.MAX_EPOCH") + 1] = "3"
    restored = []
    with pytest.MonkeyPatch.context() as mp:
        restore = port_trainer.TrainerBase._restore_optimizer
        mp.setattr(port_trainer.TrainerBase, "_restore_optimizer",
                   lambda self, saved: restored.append(restore(self, saved)) or restored[-1])
        resumed = run_port(_argv("MaPLe", MAPLE_YAML, maple["dir"] / "resumed", data_root,
                                 opts3, extra=("--resume", str(out))))
    assert restored == [True]
    assert len(resumed["losses"]) == 1
    assert resumed["trainer"].start_epoch == 2


def _flat(tree):
    from federated_multi_modal_tpu_torch.engine.tree import flatten

    return {k: v.detach().float().numpy() for k, v in flatten(tree).items()}


def test_parse_test_res_reads_the_same_accuracy(maple, data_root):
    """``tools/parse_test_res.py`` on the port's ``log.txt`` and on the JAX
    package's reads the same accuracy (the fp32 runs of the same weights)."""
    opts = MAPLE_OPTS + ["TRAINER.MAPLE.PREC", "fp32"] + maple["common"]
    run_port(_argv("MaPLe", MAPLE_YAML, maple["dir"] / "port-parse" / "seed1", data_root, opts))
    read = []
    for name in ("jax", "port-parse"):
        out = subprocess.run(
            [sys.executable, str(ROOT / "tools" / "parse_test_res.py"), str(maple["dir"] / name)],
            capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        read.append(re.findall(r"\* accuracy: ([\d.]+)%", out.stdout))
    assert read[0] == read[1] and read[0]
