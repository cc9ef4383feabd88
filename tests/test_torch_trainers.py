"""The port's CoOp and zero-shot CLIP against the JAX package's trainers,
built with ``build_trainer`` on the Synthetic dataset and the Tiny backbone
(as ``tests/test_trainers.py`` builds them), on the CPU.

CoOp is compared in fp32, where the point is the algorithm: the JAX
trainer's CLIP weights, prompt constants and context vectors are cast to
fp32 and carried into the port's program by their flat dotted names
(``load_jax_params``); the position layout is the port's own, held equal to
the JAX one. Zero-shot CLIP is compared as the trainers build it, under the
bf16 policy. Each JAX trainer sets module globals of the JAX package when
it is built (the attention implementation, the text packing, the wgrad
policy); the tests restore them afterwards.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import federated_multi_modal_tpu.models.clip_model as jax_clip
import federated_multi_modal_tpu.ops.primitives as jax_prim
import federated_multi_modal_tpu.trainers  # noqa: F401 - registers the trainers
import federated_multi_modal_tpu.trainers.zsclip as jax_zsclip
from federated_multi_modal_tpu.config import get_cfg_default
from federated_multi_modal_tpu.engine import build_trainer
from federated_multi_modal_tpu.engine.checkpoint import flatten_params
from federated_multi_modal_tpu.engine.optim import tx_with_lr
from federated_multi_modal_tpu_torch.engine.trainer import make_train_step
from federated_multi_modal_tpu_torch.engine.tree import flatten
from federated_multi_modal_tpu_torch.models import params as port_params
from federated_multi_modal_tpu_torch.ops.kernels import attention as port_attn
from federated_multi_modal_tpu_torch.trainers import coop as port_coop
from federated_multi_modal_tpu_torch.trainers import zsclip as port_zsclip
from federated_multi_modal_tpu_torch.trainers.templates import (
    CUSTOM_TEMPLATES,
    IMAGENET_TEMPLATES_SELECT,
)

N_CTX = 4
LR = 0.002


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return tmp_path_factory.mktemp("dataroot")


def _build_jax_trainer(root, out_dir, trainer, fp32_backbone=False, **overrides):
    """``tests/test_trainers.py``'s Tiny + Synthetic config, built with the
    JAX package's module globals restored afterwards; ``fp32_backbone``
    gives the zero-shot trainers fp32 CLIP weights."""
    cfg = get_cfg_default()
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
    with pytest.MonkeyPatch.context() as mp:
        for module, name in ((jax_prim, "_ATTENTION_IMPL"),
                             (jax_prim, "_VISION_ATTN_WGRAD_BLOCKS"),
                             (jax_clip, "_TEXT_PACK_DEFAULT")):
            mp.setattr(module, name, getattr(module, name))
        if fp32_backbone:
            load = jax_zsclip.load_clip_backbone
            mp.setattr(jax_zsclip, "load_clip_backbone",
                       lambda model_cfg: (lambda a, p: (a, _fp32(p)))(*load(model_cfg)))
        return build_trainer(cfg)


def _fp32(tree):
    return jax.tree.map(
        lambda x: x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.inexact) else x, tree)


def _rel_err(got, ref):
    """max |got - ref| over max |ref|: the error each test reads."""
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy()
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _images(seed, n=4):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 32, 32, 3)).astype(np.float32), rng


# -- CoOp -------------------------------------------------------------------

CASES = [(pos, csc) for pos in ("end", "middle", "front") for csc in (False, True)]
IDS = [f"{pos}-{'csc' if csc else 'shared'}" for pos, csc in CASES]


@functools.lru_cache(maxsize=None)
def _coop_case(root, position, csc):
    """The JAX CoOp trainer's fp32 loss, aux, ctx gradient, three SGD steps
    and eval logits on a seeded batch, and the port's program on the same
    weights, constants and batch."""
    trainer = _build_jax_trainer(
        root, f"{root}/coop-{position}-{csc}", "CoOp",
        **{"TRAINER.COOP.N_CTX": N_CTX, "TRAINER.COOP.CSC": csc,
           "TRAINER.COOP.CLASS_TOKEN_POSITION": position})
    trainable, frozen = _fp32(trainer.trainable), _fp32(trainer.frozen)
    images, rng = _images(7)
    n_cls = len(trainer.dm.dataset.classnames)
    batch = {"image": jnp.asarray(images),
             "label": jnp.asarray(rng.integers(0, n_cls, 4).astype(np.int32))}

    def loss(tr):
        return trainer.loss_fn(tr, frozen, batch)

    (loss0, aux0), grads0 = jax.value_and_grad(loss, has_aux=True)(trainable)
    logits = trainer.eval_apply_fn(trainable, frozen, batch["image"],
                                   trainer.eval_prepare_fn(trainable, frozen))
    cfg = types.SimpleNamespace(NAME="sgd", WEIGHT_DECAY=5e-4, MOMENTUM=0.9,
                                SGD_NESTEROV=False)
    tx = tx_with_lr(cfg, LR, 0.0)

    @jax.jit
    def step(tr, st):
        (value, _), grads = jax.value_and_grad(loss, has_aux=True)(tr)
        updates, st = tx.update(grads, st, tr)
        return jax.tree.map(lambda p, u: p + u, tr, updates), st, value

    steps, tr, st = [], trainable, tx.init(trainable)
    for _ in range(3):
        tr, st, value = step(tr, st)
        steps.append((float(value), np.asarray(tr["prompt_learner"]["ctx"])))

    prog = port_coop.build_coop_program(
        "Tiny", classnames=trainer.dm.dataset.classnames, n_ctx=N_CTX, csc=csc,
        class_token_position=position, device="cpu")
    pc = frozen["prompt_const"]
    port_frozen = {
        "clip": port_params.load_jax_params(flatten_params(frozen["clip"]), device="cpu"),
        "prompt_const": dict(
            port_params.load_jax_params({k: np.asarray(pc[k]) for k in
                                         ("full_embedding", "eot_index")}, device="cpu"),
            layout=prog["frozen"]["prompt_const"]["layout"]),
    }
    return {
        "jax": {"loss": float(loss0), "acc": float(aux0["acc"]),
                "ctx_grad": np.asarray(grads0["prompt_learner"]["ctx"]),
                "logits": np.asarray(logits), "steps": steps, "layout": pc["layout"],
                "text_len": trainer.const.text_len,
                "eot_index": np.asarray(trainer.const.eot_index)},
        "prog": prog, "frozen": port_frozen, "csc": csc,
        "trainable": port_params.load_jax_params(flatten_params(trainable), device="cpu"),
        "batch": port_params.load_jax_params({k: np.asarray(v) for k, v in batch.items()},
                                             device="cpu"),
    }


@pytest.fixture
def coop_case(request, data_root):
    position, csc = request.param
    return _coop_case(str(data_root), position, csc)


# fp32 readings over the six cases, as max |error| over max |value| (loss
# relative): the loss at most 5.1e-7, the ctx gradient 4.2e-6, the eval
# logits 1.4e-6, the loss and the ctx of each of three SGD steps 6.3e-7 and
# 5.2e-7. Tolerances are those of ``tests/test_torch_train.py``: loss 2e-6,
# gradients and parameters 5e-5, logits 1e-5.
@pytest.mark.parametrize("coop_case", CASES, ids=IDS, indirect=True)
def test_coop_layout_and_constants_match_jax(coop_case):
    """The port's class-token layout, EOT positions and truncation length
    equal the JAX trainer's."""
    ref = coop_case["jax"]
    prog = coop_case["prog"]
    for got, want in zip(prog["frozen"]["prompt_const"]["layout"], ref["layout"]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        prog["frozen"]["prompt_const"]["eot_index"].numpy(), ref["eot_index"])
    assert prog["text_len"] == ref["text_len"]


@pytest.mark.parametrize("coop_case", CASES, ids=IDS, indirect=True)
def test_coop_loss_acc_and_ctx_gradient_match_jax(coop_case):
    ref = coop_case["jax"]
    ctx = coop_case["trainable"]["prompt_learner"]["ctx"].clone().requires_grad_(True)
    loss, aux = coop_case["prog"]["loss_fn"]({"prompt_learner": {"ctx": ctx}},
                                             coop_case["frozen"], coop_case["batch"])
    (grad,) = torch.autograd.grad(loss, ctx)
    assert abs(loss.item() - ref["loss"]) <= 2e-6 * abs(ref["loss"])
    assert float(aux["acc"]) == pytest.approx(ref["acc"])
    assert grad.shape == ctx.shape and ctx.ndim == (3 if coop_case["csc"] else 2)
    assert _rel_err(grad, ref["ctx_grad"]) < 5e-5


@pytest.mark.parametrize("coop_case", CASES, ids=IDS, indirect=True)
def test_coop_three_sgd_steps_match_jax(coop_case):
    """``make_train_step`` with CoOp's SGD (lr 0.002, momentum 0.9, weight
    decay 5e-4, no clip) against the same chain in optax."""
    tx = port_coop.build_coop_optimizer()
    step = make_train_step(coop_case["prog"]["loss_fn"], tx)
    trainable = coop_case["trainable"]
    opt_state = tx.init(trainable)
    for value, ctx in coop_case["jax"]["steps"]:
        trainable, opt_state, loss, _ = step(trainable, coop_case["frozen"], opt_state,
                                             coop_case["batch"])
        assert abs(float(loss) - value) <= 2e-6 * abs(value)
        assert _rel_err(trainable["prompt_learner"]["ctx"], ctx) < 5e-5
    assert set(flatten(trainable)) == {"prompt_learner.ctx"}


@pytest.mark.parametrize("coop_case", CASES, ids=IDS, indirect=True)
def test_coop_eval_logits_match_jax(coop_case):
    """The prompt-cached eval: text features once, then the frozen image
    tower on the batch."""
    prog = coop_case["prog"]
    txt = prog["eval_prepare_fn"](coop_case["trainable"], coop_case["frozen"])
    got = prog["eval_apply_fn"](coop_case["trainable"], coop_case["frozen"],
                                coop_case["batch"]["image"], txt)
    assert got.shape == coop_case["jax"]["logits"].shape
    assert _rel_err(got, coop_case["jax"]["logits"]) < 1e-5


# -- zero-shot CLIP -----------------------------------------------------------

# The trainers on fp32 CLIP weights (their backbone loader wrapped to cast),
# as max |error| over max |value|: the text features read at most 8.4e-7
# and the logits 1.5e-6; tolerance 1e-5, as the CoOp logits.
@pytest.mark.parametrize("trainer_name", ["ZeroshotCLIP", "ZeroshotCLIP2"])
def test_zeroshot_text_features_and_logits_match_jax(trainer_name, data_root, tmp_path,
                                                     monkeypatch):
    """One template (the Synthetic dataset's) or the ImageNet select
    ensemble plus it: the normalized class features and the cosine logits
    of a seeded batch, against the JAX trainer's ``text_features`` and
    ``model_inference``. At 77 tokens the text tower runs K1 under the
    77x77 causal mask."""
    trainer = _build_jax_trainer(data_root, tmp_path, trainer_name, fp32_backbone=True)
    templates = [CUSTOM_TEMPLATES["Synthetic"]]
    if trainer_name == "ZeroshotCLIP2":
        templates = list(IMAGENET_TEMPLATES_SELECT) + templates
    clip = port_params.load_jax_params(flatten_params(trainer.clip_params), device="cpu")
    masks = []
    k1 = port_attn.packed_attention_masked
    monkeypatch.setattr(port_attn, "packed_attention_masked",
                        lambda qkv, mask, n: masks.append(tuple(mask.shape)) or k1(qkv, mask, n))
    feats = port_zsclip.zeroshot_text_features(
        clip, trainer.arch, trainer.dm.dataset.classnames, templates, device="cpu")
    assert masks == [(77, 77)] * (trainer.arch.transformer_layers * len(templates))
    images, _ = _images(8)
    logits = port_zsclip.make_zeroshot_infer(trainer.arch)(clip, feats, torch.from_numpy(images))
    ref_logits = trainer.model_inference(jnp.asarray(images))
    assert feats.shape == trainer.text_features.shape
    assert _rel_err(feats, trainer.text_features) < 1e-5
    assert _rel_err(logits, ref_logits) < 1e-5
