"""The port's base-to-novel trainers, VPT, IVLP and CoCoOp, against the JAX
package's, on the Synthetic dataset and the Tiny backbone, on the CPU.

Each JAX trainer is built once per case with ``build_trainer`` under
``TRAINER.*.PREC fp32`` (as ``tests/test_torch_trainers.py`` builds CoOp),
and its weights, prompt constants and initial prompts are carried into the
port's functions by their flat dotted names (``load_jax_params``): the two
packages draw their random prompts from other generators. Held: the state
the port builds itself (names and shapes of the trainable leaves, the
frozen text features or prompt constants), the loss, every trainable leaf's
gradient, three SGD steps and the eval logits; then both command lines,
trained on the base classes and evaluated on the novel ones from each
package's checkpoint.
"""

import functools
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import federated_multi_modal_tpu.models.clip_model as jax_clip
import federated_multi_modal_tpu.ops.primitives as jax_prim
import federated_multi_modal_tpu.trainers  # noqa: F401 - registers the trainers
from federated_multi_modal_tpu.config import get_cfg_default
from federated_multi_modal_tpu.engine import build_trainer
from federated_multi_modal_tpu.engine.checkpoint import flatten_params
from federated_multi_modal_tpu.engine.optim import tx_with_lr
from federated_multi_modal_tpu_torch.config import get_cfg_default as port_cfg_default
from federated_multi_modal_tpu_torch.engine import build_trainer as port_build
from federated_multi_modal_tpu_torch.engine.optim import build_optimizer
from federated_multi_modal_tpu_torch.engine.trainer import make_train_step
from federated_multi_modal_tpu_torch.engine.tree import flatten, unflatten
from federated_multi_modal_tpu_torch.models import clip_model as port_clip
from federated_multi_modal_tpu_torch.models import params as port_params
from federated_multi_modal_tpu_torch.ops import primitives as port_prim
from federated_multi_modal_tpu_torch.trainers import cocoop as port_cocoop
from federated_multi_modal_tpu_torch.trainers import ivlp as port_ivlp
from federated_multi_modal_tpu_torch.trainers import vpt as port_vpt

ROOT = Path(__file__).resolve().parents[1]
LR = 0.002
# max |error| over max |value| (the loss relative), as tests/test_torch_train.py
TOL_LOSS, TOL_GRAD, TOL_LOGITS = 2e-6, 5e-5, 1e-5

# case -> (trainer, configuration options)
CASES = {
    "VPT": ("VPT", {"TRAINER.VPT.N_CTX_VISION": 2, "TRAINER.VPT.PROMPT_DEPTH_VISION": 3}),
    "IVLP": ("IVLP", {"TRAINER.IVLP.N_CTX_TEXT": 2, "TRAINER.IVLP.N_CTX_VISION": 2,
                      "TRAINER.IVLP.PROMPT_DEPTH_TEXT": 3,
                      "TRAINER.IVLP.PROMPT_DEPTH_VISION": 3}),
    "IVLP-language-only": ("IVLP", {"TRAINER.IVLP.N_CTX_TEXT": 2,
                                    "TRAINER.IVLP.N_CTX_VISION": 0,
                                    "TRAINER.IVLP.PROMPT_DEPTH_TEXT": 3,
                                    "TRAINER.IVLP.PROMPT_DEPTH_VISION": 3}),
    "CoCoOp": ("CoCoOp", {"TRAINER.COCOOP.N_CTX": 2, "TRAINER.COCOOP.CTX_INIT": ""}),
    "CoCoOp-ctx-init": ("CoCoOp", {"TRAINER.COCOOP.N_CTX": 2,
                                   "TRAINER.COCOOP.CTX_INIT": "a photo of a"}),
}
PREC_KEY = {"VPT": "TRAINER.VPT.PREC", "IVLP": "TRAINER.IVLP.PREC",
            "CoCoOp": "TRAINER.COCOOP.PREC"}


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return tmp_path_factory.mktemp("dataroot")


def _cfg(root, out_dir, trainer, overrides, defaults=get_cfg_default):
    """``tests/test_trainers.py``'s Tiny + Synthetic configuration, on
    ``defaults()`` (the JAX package's, or the port's)."""
    cfg = defaults()
    cfg.DATASET.ROOT = str(root)
    cfg.DATASET.NAME = "Synthetic"
    cfg.MODEL.BACKBONE.NAME = "Tiny"
    cfg.INPUT.SIZE = (32, 32)
    cfg.INPUT.CANVAS_SIZE = 40
    cfg.DATALOADER.TRAIN_X.BATCH_SIZE = 4
    cfg.DATALOADER.TEST.BATCH_SIZE = 8
    cfg.TRAINER.NAME = trainer
    cfg.OUTPUT_DIR = str(out_dir)
    cfg.SEED = 1
    cfg.VERBOSE = False
    for key, value in overrides.items():
        node = cfg
        *parents, last = key.split(".")
        for k in parents:
            node = node[k]
        node[last] = value
    return cfg


def _build_jax(cfg):
    """``build_trainer(cfg)`` with the JAX package's module globals put back."""
    with pytest.MonkeyPatch.context() as mp:
        for module, name in ((jax_prim, "_ATTENTION_IMPL"),
                             (jax_prim, "_VISION_ATTN_WGRAD_BLOCKS"),
                             (jax_clip, "_TEXT_PACK_DEFAULT")):
            mp.setattr(module, name, getattr(module, name))
        return build_trainer(cfg)


def _fp32(tree):
    return jax.tree.map(
        lambda x: x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.inexact) else x, tree)


def _rel_err(got, ref):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy() if hasattr(got, "detach") else np.asarray(got)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _port_tree(jax_tree):
    return port_params.load_jax_params(flatten_params(jax_tree), device="cpu")


def _port_fns(trainer_name, arch, text_len):
    if trainer_name == "VPT":
        return port_vpt.make_vpt_fns(arch)
    if trainer_name == "IVLP":
        return port_ivlp.make_ivlp_fns(arch, text_len)
    return port_cocoop.make_cocoop_fns(arch, text_len)


def _eval_logits(fns, trainable, frozen, images):
    """The eval path: the prompt cache where the trainer has one (VPT,
    IVLP), else ``logits_fn`` (CoCoOp, as its ``test()`` runs it)."""
    if "eval_apply_fn" in fns:
        return fns["eval_apply_fn"](trainable, frozen, images,
                                    fns["eval_prepare_fn"](trainable, frozen))
    return fns["logits_fn"](trainable, frozen, images)


@functools.lru_cache(maxsize=None)
def _case(root, case):
    """The JAX trainer's fp32 loss, gradients, three SGD steps and eval
    logits on a seeded batch of 4, and the port's functions on the same
    weights, constants and batch."""
    trainer_name, overrides = CASES[case]
    cfg = _cfg(root, f"{root}/{case}", trainer_name,
               {**overrides, PREC_KEY[trainer_name]: "fp32"})
    trainer = _build_jax(cfg)
    trainable, frozen = _fp32(trainer.trainable), _fp32(trainer.frozen)
    rng = np.random.default_rng(7)
    images = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    n_cls = len(trainer.dm.dataset.classnames)
    batch = {"image": jnp.asarray(images),
             "label": jnp.asarray(rng.integers(0, n_cls, 4).astype(np.int32))}

    def loss(tr):
        return trainer.loss_fn(tr, frozen, batch)

    (loss0, _), grads0 = jax.value_and_grad(loss, has_aux=True)(trainable)
    if getattr(trainer, "eval_prepare_fn", None) is not None:
        logits = trainer.eval_apply_fn(trainable, frozen, batch["image"],
                                       trainer.eval_prepare_fn(trainable, frozen))
    else:
        logits = trainer.logits_fn(trainable, frozen, batch["image"])
    tx = tx_with_lr(types.SimpleNamespace(NAME="sgd", WEIGHT_DECAY=5e-4, MOMENTUM=0.9,
                                          SGD_NESTEROV=False), LR, 0.0)

    @jax.jit
    def step(tr, st):
        (value, _), grads = jax.value_and_grad(loss, has_aux=True)(tr)
        updates, st = tx.update(grads, st, tr)
        return jax.tree.map(lambda p, u: p + u, tr, updates), st, value

    steps, tr, st = [], trainable, tx.init(trainable)
    for _ in range(3):
        tr, st, value = step(tr, st)
        steps.append((float(value), flatten_params(tr)))

    port_trainable = _port_tree(trainable)
    if trainer_name == "IVLP":
        port_trainable.setdefault("vpt", {})  # language-only: no vision leaf
    const = getattr(trainer, "const", None)
    text_len = const.text_len if const is not None else None
    return {
        "trainer": trainer_name, "cfg": cfg, "arch": port_params.BACKBONE_CONFIGS["Tiny"],
        "classnames": list(trainer.dm.dataset.classnames), "text_len": text_len,
        "jax": {"loss": float(loss0), "grads": flatten_params(grads0),
                "trainable": flatten_params(trainable), "frozen": frozen,
                "logits": np.asarray(logits), "steps": steps},
        "fns": _port_fns(trainer_name, port_params.BACKBONE_CONFIGS["Tiny"], text_len),
        "trainable": port_trainable, "frozen": _port_tree(frozen),
        "batch": port_params.load_jax_params({k: np.asarray(v) for k, v in batch.items()},
                                             device="cpu"),
    }


@pytest.fixture
def case(request, data_root):
    return _case(str(data_root), request.param)


# fp32 readings over the five cases, as max |error| over max |value| (the
# loss relative): the loss at most 3.7e-7, a gradient 6.0e-6, the eval logits
# 1.8e-6, the loss and every leaf of each of three SGD steps 4.4e-7 and
# 2.6e-7; the tolerances above are tests/test_torch_train.py's.
@pytest.mark.parametrize("case", list(CASES), indirect=True)
def test_port_state_matches_jax(case):
    """The state the port builds from the same CLIP weights: its trainable
    leaves have the JAX trainer's names and shapes, and its frozen text
    features (VPT) or prompt constants (IVLP, CoCoOp) equal the JAX
    trainer's; a context from ``CTX_INIT`` equals JAX's."""
    tcfg_name = {"VPT": "VPT", "IVLP": "IVLP", "CoCoOp": "COCOOP"}[case["trainer"]]
    tcfg = case["cfg"].TRAINER[tcfg_name]
    clip, arch, names = case["frozen"]["clip"], case["arch"], case["classnames"]
    gen = torch.Generator().manual_seed(1)
    if case["trainer"] == "VPT":
        trainable, frozen = port_vpt.vpt_state(clip, arch, names, tcfg.N_CTX_VISION,
                                               tcfg.PROMPT_DEPTH_VISION, gen)
        assert _rel_err(frozen["text_features"],
                        case["jax"]["frozen"]["text_features"]) < TOL_LOGITS
    else:
        if case["trainer"] == "IVLP":
            trainable, frozen, const = port_ivlp.ivlp_state(
                clip, arch, names, tcfg.N_CTX_TEXT, tcfg.N_CTX_VISION,
                tcfg.PROMPT_DEPTH_TEXT, tcfg.PROMPT_DEPTH_VISION, tcfg.CTX_INIT, gen)
        else:
            trainable, frozen, const, _ = port_cocoop.cocoop_state(
                clip, arch, names, tcfg.N_CTX, tcfg.CTX_INIT, gen)
        assert const.text_len == case["text_len"]
        ref = case["jax"]["frozen"]["prompt_const"]
        got = frozen["prompt_const"]
        np.testing.assert_array_equal(got["eot_index"].numpy(), np.asarray(ref["eot_index"]))
        for key in ("token_prefix", "token_suffix"):
            assert _rel_err(got[key], ref[key]) == 0.0, key
        if tcfg.CTX_INIT and (case["trainer"] == "CoCoOp" or tcfg.N_CTX_TEXT <= 4):
            assert _rel_err(trainable["prompt_learner"]["ctx"],
                            case["jax"]["trainable"]["prompt_learner.ctx"]) == 0.0
    shapes = {k: tuple(v.shape) for k, v in flatten(trainable).items()}
    assert shapes == {k: v.shape for k, v in case["jax"]["trainable"].items()}
    assert all(v.dtype == torch.float32 for v in flatten(trainable).values())


@pytest.mark.parametrize("case", list(CASES), indirect=True)
def test_loss_and_every_gradient_match_jax(case):
    ref = case["jax"]
    leaves = {k: v.clone().requires_grad_(True) for k, v in flatten(case["trainable"]).items()}
    tr = unflatten(leaves)
    if case["trainer"] == "IVLP":
        tr.setdefault("vpt", {})
    loss, _ = case["fns"]["loss_fn"](tr, case["frozen"], case["batch"])
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    assert abs(loss.item() - ref["loss"]) <= TOL_LOSS * abs(ref["loss"])
    assert set(leaves) == set(ref["grads"])
    for (name, leaf), grad in zip(leaves.items(), grads):
        assert grad is not None and grad.shape == leaf.shape, name
        assert float(grad.abs().max()) > 0, name
        assert _rel_err(grad, ref["grads"][name]) < TOL_GRAD, name


@pytest.mark.parametrize("case", list(CASES), indirect=True)
def test_three_sgd_steps_match_jax(case):
    """``make_train_step`` with SGD (lr 0.002, momentum 0.9, weight decay
    5e-4, no clip) against the same chain in optax: each step's loss and
    every trainable leaf after it."""
    tx = build_optimizer(lr=LR, momentum=0.9, weight_decay=5e-4, clip=0.0)
    step = make_train_step(case["fns"]["loss_fn"], tx)
    trainable = case["trainable"]
    opt_state = tx.init(trainable)
    for value, params in case["jax"]["steps"]:
        trainable, opt_state, loss, _ = step(trainable, case["frozen"], opt_state,
                                             case["batch"])
        assert abs(float(loss) - value) <= TOL_LOSS * abs(value)
        got = flatten(trainable)
        assert set(got) == set(params)
        for name, leaf in got.items():
            assert _rel_err(leaf, params[name]) < TOL_GRAD, name


@pytest.mark.parametrize("case", list(CASES), indirect=True)
def test_eval_logits_match_jax(case):
    """VPT and IVLP through their prompt cache (the text features once,
    then the prompted image tower with ``inference=True``); CoCoOp through
    ``logits_fn``, as its ``test()`` runs it."""
    got = _eval_logits(case["fns"], case["trainable"], case["frozen"],
                       case["batch"]["image"])
    assert got.shape == case["jax"]["logits"].shape
    assert _rel_err(got, case["jax"]["logits"]) < TOL_LOGITS


def test_cocoop_conditioning_is_per_image(data_root, monkeypatch):
    """Each image gets its own conditional prompts: permuting the batch
    permutes the logits' rows (``tests/test_trainers.py:163``, on the port's
    trainer, whose construction sets the port's module globals: put back)."""
    for module, attr in ((port_prim, "_ATTENTION_IMPL"), (port_clip, "_TEXT_PACK_DEFAULT")):
        monkeypatch.setattr(module, attr, getattr(module, attr))
    cfg = _cfg(data_root, f"{data_root}/ccd", "CoCoOp", {"TRAINER.COCOOP.N_CTX": 2},
               defaults=port_cfg_default)
    trainer = port_build(cfg, device="cpu")
    images = trainer.parse_batch_images(next(iter(trainer.test_loader)))
    with torch.no_grad():
        logits = trainer.logits_fn(trainer.trainable, trainer.frozen, images)
        perm = torch.tensor([1, 0] + list(range(2, images.shape[0])))
        logits_p = trainer.logits_fn(trainer.trainable, trainer.frozen, images[perm])
    np.testing.assert_allclose(logits[perm].numpy(), logits_p.numpy(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("trainer_name,key", [("VPT", "TRAINER.VPT.PROMPT_DEPTH_VISION"),
                                              ("IVLP", "TRAINER.IVLP.PROMPT_DEPTH_TEXT")])
def test_check_cfg_refuses_what_jax_refuses(trainer_name, key, data_root, tmp_path):
    """A prompt depth of 0 (VPT's vision, IVLP's text) is refused by both
    packages' ``check_cfg`` before anything is built."""
    with pytest.raises(AssertionError, match="(?i)depth"):
        _build_jax(_cfg(data_root, tmp_path / "jax", trainer_name, {key: 0}))
    with pytest.raises(AssertionError, match="(?i)depth"):
        port_build(_cfg(data_root, tmp_path / "port", trainer_name, {key: 0},
                        defaults=port_cfg_default), device="cpu")


# -- both command lines, base classes then novel ones ------------------------------

sys.path.insert(0, str(ROOT))  # the repository's train.py
import train as jax_cli  # noqa: E402
from federated_multi_modal_tpu.engine.checkpoint import save_checkpoint as jax_save  # noqa: E402
from federated_multi_modal_tpu_torch import train as port_cli  # noqa: E402

# fp32 (TRAINER.*.PREC fp32): tests/test_torch_cli.py's limit on the
# per-epoch mean losses (the same arithmetic in another order of sums)
FP32_LOSS_RTOL = 1e-4
CLI = {
    "VPT": ("configs/trainers/VPT/vit_b16_c2_ep5_batch4_4.yaml",
            ["TRAINER.VPT.PROMPT_DEPTH_VISION", "3"]),
    "IVLP": ("configs/trainers/IVLP/vit_b16_c2_ep5_batch4_2+2ctx.yaml",
             ["TRAINER.IVLP.PROMPT_DEPTH_TEXT", "3", "TRAINER.IVLP.PROMPT_DEPTH_VISION", "3"]),
    "CoCoOp": ("configs/trainers/CoCoOp/vit_b16_c4_ep10_batch1.yaml", []),
}
# the registered model each trainer checkpoints under
MODEL_NAME = {"VPT": "prompt_learner", "IVLP": "VLPromptLearner", "CoCoOp": "prompt_learner"}
MODULE_GLOBALS = ((jax_prim, "_ATTENTION_IMPL"), (jax_prim, "_VISION_ATTN_WGRAD_BLOCKS"),
                  (jax_clip, "_TEXT_PACK_DEFAULT"), (port_prim, "_ATTENTION_IMPL"),
                  (port_clip, "_TEXT_PACK_DEFAULT"))


def _jax_parser():
    """``train.py``'s parser, which it builds inline under ``__main__``."""
    source = (ROOT / "train.py").read_text()
    body = source.split('if __name__ == "__main__":\n', 1)[1]
    body = body.replace("    main(parser.parse_args())", "    return parser")
    namespace = {"argparse": __import__("argparse")}
    exec("def build_parser():\n" + body, namespace)
    return namespace["build_parser"]()


def _argv(trainer, out, data_root, opts, extra=()):
    yaml, depth = CLI[trainer]
    return ["--root", str(data_root), "--seed", "1", "--trainer", trainer,
            "--dataset-config-file", str(ROOT / "configs/datasets/synthetic.yaml"),
            "--config-file", str(ROOT / yaml), "--output-dir", str(out), *extra,
            "MODEL.BACKBONE.NAME", "Tiny", "INPUT.SIZE", "(32, 32)", "INPUT.CANVAS_SIZE", "40",
            "DATALOADER.TEST.BATCH_SIZE", "8", "TPU.DATA_PARALLEL", "False", "VERBOSE", "False",
            "OPTIM.MAX_EPOCH", "2", PREC_KEY[trainer], "fp32", *depth, *opts]


def _main(cli, argv, registry, name):
    """``cli.main`` in process on ``argv``: the mean loss of each epoch, each
    ``test()``'s result, and the last trainer tested."""
    record = {"losses": [], "tests": []}
    cls = registry.get(name)
    run_epoch, test = cls.run_epoch, cls.test

    def run_epoch_rec(self, *args, **kwargs):
        loss = run_epoch(self, *args, **kwargs)
        record["losses"].append(float(loss))
        return loss

    def test_rec(self, *args, **kwargs):
        result = test(self, *args, **kwargs)
        record["tests"].append(result["accuracy"])
        record["trainer"] = self
        return result

    parser = _jax_parser() if cli is jax_cli else port_cli.build_parser()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "stdout", sys.stdout)  # main tees it into log.txt
        mp.setenv("FMM_TPU_PLATFORM", "cpu")
        for module, attr in MODULE_GLOBALS:
            mp.setattr(module, attr, getattr(module, attr))
        mp.setattr(cls, "run_epoch", run_epoch_rec)
        mp.setattr(cls, "test", test_rec)
        cli.main(parser.parse_args(argv))
    return record


@pytest.fixture(scope="module")
def tiny_weights(tmp_path_factory):
    """A Tiny CLIP in OpenAI's state-dict layout (fp16), ``torch.save``d."""
    path = tmp_path_factory.mktemp("weights") / "tiny_openai.pt"
    arch = port_params.BACKBONE_CONFIGS["Tiny"]
    tree = port_params.init_clip_params(arch, torch.Generator().manual_seed(11),
                                        dtype_policy=False)
    torch.save(port_params.export_openai_state_dict(tree, arch), path)
    return path


@pytest.mark.parametrize("trainer", list(CLI))
def test_command_line_base_to_novel_matches_jax(trainer, tiny_weights, data_root, tmp_path):
    """Each package's ``train.py`` on the same OpenAI-format weights and the
    JAX trainer's initial prompts (``MODEL.INIT_WEIGHTS``), two epochs on
    the base classes in fp32: each epoch's mean loss within
    ``FP32_LOSS_RTOL`` and the same final accuracy. Then ``--eval-only
    --load-epoch 2`` on the novel classes, each package from its own
    checkpoint and from the other's: the class-conditioned buffers of the
    base classes are dropped, the prompts loaded, and both packages read
    the same accuracy from the same checkpoint."""
    from federated_multi_modal_tpu.engine.registry import TRAINER_REGISTRY as JAX_TRAINERS
    from federated_multi_modal_tpu_torch.engine.registry import TRAINER_REGISTRY

    weights = ["MODEL.BACKBONE.WEIGHTS_PATH", str(tiny_weights)]
    init_args = _jax_parser().parse_args(_argv(
        trainer, tmp_path / "init-run", data_root,
        weights + ["DATASET.SUBSAMPLE_CLASSES", "base"]))
    init = _build_jax(jax_cli.setup_cfg(init_args))
    jax_save({"epoch": 0, "state_dict": flatten_params(init.trainable)},
             str(tmp_path / "init"), model_name="init.pth.tar")
    base = weights + ["MODEL.INIT_WEIGHTS", str(tmp_path / "init" / "init.pth.tar"),
                      "DATASET.SUBSAMPLE_CLASSES", "base"]
    ref = _main(jax_cli, _argv(trainer, tmp_path / "jax", data_root, base),
                JAX_TRAINERS, trainer)
    got = _main(port_cli, _argv(trainer, tmp_path / "port", data_root, base),
                TRAINER_REGISTRY, trainer)
    assert len(got["losses"]) == len(ref["losses"]) == 2
    rel = np.abs(np.subtract(got["losses"], ref["losses"])) / np.abs(ref["losses"])
    assert np.all(rel <= FP32_LOSS_RTOL), (got["losses"], ref["losses"])
    assert got["tests"] == ref["tests"] and got["tests"]
    n_base = len(got["trainer"].dm.dataset.classnames)

    novel = weights + ["DATASET.SUBSAMPLE_CLASSES", "new"]
    for who in ("jax", "port"):
        extra = ("--eval-only", "--model-dir", str(tmp_path / who), "--load-epoch", "2")
        ckpt = tmp_path / who / MODEL_NAME[trainer] / "model.pth.tar-2"
        assert ckpt.is_file()
        jax_eval = _main(jax_cli, _argv(trainer, tmp_path / f"jax-eval-{who}", data_root,
                                        novel, extra), JAX_TRAINERS, trainer)
        port_eval = _main(port_cli, _argv(trainer, tmp_path / f"port-eval-{who}", data_root,
                                          novel, extra), TRAINER_REGISTRY, trainer)
        assert port_eval["tests"] == jax_eval["tests"] and len(port_eval["tests"]) == 1
        port_trainer = port_eval["trainer"]
        assert len(port_trainer.dm.dataset.classnames) == n_base  # Synthetic: 2 and 2
        assert port_trainer.dm.dataset.classnames != got["trainer"].dm.dataset.classnames
        # every leaf loaded from the checkpoint (token_prefix/suffix dropped)
        loaded = flatten(port_trainer.trainable)
        trained = flatten(got["trainer"].trainable if who == "port"
                          else port_params.load_jax_params(
                              flatten_params(ref["trainer"].trainable), device="cpu"))
        assert set(loaded) == set(trained)
        for name, leaf in loaded.items():
            np.testing.assert_array_equal(leaf.numpy(), trained[name].float().numpy(), name)
