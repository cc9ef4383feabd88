"""The system under test: the port's MaPLe program, driven as its users drive it.

Everything here calls ``federated_multi_modal_tpu_torch``: CLIP's weights
read through the port's own loader (``convert_torch_state_dict``, the path
of ``MODEL.BACKBONE.WEIGHTS_PATH``), the program assembled as
``flagship.build_maple_program`` assembles it (prompt constants and context
vectors from the init phrase, the trainable split, the loss and the
prompt-cached eval functions), the engine's train step
(``engine/trainer.py::make_train_step_with_aux`` over
``engine/optim.py``'s SGD with its clip) with the on-device crop
(``ops/preprocess.py``), and the port bench's CUDA-graph dispatch
(``bench.capture_step``, what ``--dispatch scan`` replays).
"""

from __future__ import annotations

import torch

from federated_multi_modal_tpu_torch.bench import capture_step
from federated_multi_modal_tpu_torch.engine.optim import build_optimizer
from federated_multi_modal_tpu_torch.engine.trainer import make_train_step_with_aux
from federated_multi_modal_tpu_torch.engine.tree import (
    cast_tree,
    flatten,
    split_tree,
    to_device,
    unflatten,
)
from federated_multi_modal_tpu_torch.models.params import (
    convert_torch_state_dict,
    infer_config_from_state_dict,
)
from federated_multi_modal_tpu_torch.ops.kernels import _build
from federated_multi_modal_tpu_torch.ops.preprocess import crop_resize_flip_normalize
from federated_multi_modal_tpu_torch.trainers.common import build_prompt_constants, ctx_init_vectors
from federated_multi_modal_tpu_torch.trainers.maple import (
    make_maple_eval_fns,
    make_maple_model_fns,
    maple_trainable_predicate,
)

WIDTHS = ("embed_dim", "image_resolution", "vision_layers", "vision_width",
          "vision_patch_size", "context_length", "vocab_size", "transformer_width",
          "transformer_heads", "transformer_layers")


def build_kernels(device) -> None:
    """The port's CUDA library, built once into its build directory inside
    the checkout and loaded (set-up, not the window)."""
    if device.type == "cuda":
        _build.library()


def build(sd: dict, pl: dict, cfg: dict, classnames, use_captions: bool, device) -> dict:
    """The program's state from an OpenAI state dict ``sd`` and the prompt
    learner's initial values ``pl`` (flat, without ``ctx``)."""
    arch = infer_config_from_state_dict(sd)
    for key in WIDTHS:
        if getattr(arch, key) != cfg[key]:
            raise ValueError(f"{key}: the state dict has {getattr(arch, key)}, "
                             f"the configuration {cfg[key]}")
    m = cfg["maple"]
    depth = min(m["prompt_depth"], arch.vision_layers)
    clip = to_device(convert_torch_state_dict(sd, arch), device)
    const = build_prompt_constants(clip["text"], classnames, m["ctx_init"], m["n_ctx"])
    prompt_learner = unflatten(dict(pl, ctx=ctx_init_vectors(clip["text"], m["ctx_init"],
                                                             m["n_ctx"])))
    model = {"clip": clip, "prompt_learner": prompt_learner}
    trainable, frozen = split_tree(model, maple_trainable_predicate(
        arch.vision_layers, arch.transformer_layers))
    frozen = {"model": frozen, "prompt_const": {"token_prefix": const.token_prefix,
                                                "token_suffix": const.token_suffix,
                                                "eot_index": const.eot_index}}
    _, loss_fn = make_maple_model_fns(arch, depth, const.text_len, use_captions,
                                      m["align_lambda"])
    prepare, apply = make_maple_eval_fns(arch, depth, const.text_len)
    return {"arch": arch, "trainable": to_device(cast_tree(trainable, torch.float32), device),
            "frozen": frozen, "loss_fn": loss_fn, "eval_prepare_fn": prepare,
            "eval_apply_fn": apply, "text_len": const.text_len}


def optimizer(cfg: dict):
    o = cfg["optim"]
    return build_optimizer(lr=o["lr"], momentum=o["momentum"],
                           weight_decay=o["weight_decay"], clip=o["clip_norm"])


def train_step(prog: dict, cfg: dict, inputs: dict, draw):
    """``(step, state)``: ``step(state, run) -> (state, (loss, gnorm, boxes,
    flips))``, one optimizer step on the crops ``draw()`` gives, and the
    state it starts from (the trainable leaves, the optimizer's state, a
    count of steps whose loss was not finite)."""
    tx = optimizer(cfg)
    engine_step = make_train_step_with_aux(prog["loss_fn"], tx)
    frozen, out = prog["frozen"], prog["arch"].image_resolution

    def step(state, run=None):
        trainable, opt, bad = state
        boxes, flips = draw()
        batch = {"image": crop_resize_flip_normalize(inputs["canvas"], boxes, flips, out),
                 "label": inputs["labels"]}
        if "captions" in inputs:
            batch["caption_tokens"] = inputs["captions"]
        trainable, opt, loss, gnorm, _ = engine_step(trainable, frozen, opt, batch)
        bad = bad + (~torch.isfinite(loss)).to(bad.dtype)
        return (trainable, opt, bad), (loss, gnorm, boxes, flips)

    trainable = prog["trainable"]
    bad = torch.zeros((), dtype=torch.int32, device=inputs["canvas"].device)
    return step, (trainable, tx.init(trainable), bad)


def eval_step(prog: dict, inputs: dict, boxes, flips, roll: int):
    """``(step, state)``: the text features made once (``eval_prepare_fn``),
    then ``step(state, run) -> (state, logits)``: the centre crops of
    the canvas through ``eval_apply_fn`` and the canvas moved on by
    ``roll`` images."""
    prep = prog["eval_prepare_fn"](prog["trainable"], prog["frozen"])
    out = prog["arch"].image_resolution

    def step(state, run=None):
        canvas, bad = state
        images = crop_resize_flip_normalize(canvas, boxes, flips, out)
        logits = prog["eval_apply_fn"](prog["trainable"], prog["frozen"], images, prep)
        bad = bad + (~torch.isfinite(logits).all(-1)).sum(dtype=bad.dtype)
        return (torch.roll(canvas, roll, 0), bad), logits

    bad = torch.zeros((), dtype=torch.int32, device=inputs["canvas"].device)
    return step, (inputs["canvas"].clone(), bad)


class Runner:
    """Replays a step: on the card the port bench's captured CUDA graph,
    each replay reading what the last one left; on the CPU (tests) eager
    calls that carry the state."""

    def __init__(self, step, state, generators=()):
        # the step is kept: a replay reads tensors that only its closure holds
        self.state, self.step, self.graph, self.out = state, step, None, None
        if leaf(state).device.type == "cuda":
            self.graph, self.out, _ = capture_step(step, state, generators)

    def __call__(self):
        if self.graph is not None:
            self.graph.replay()
        else:
            self.state, self.out = self.step(self.state)
        return self.out


def leaf(tree) -> torch.Tensor:
    return next(iter(flatten({"t": tree}).values()))


def trainable_flat(state) -> dict:
    """The trainable leaves by the reference's names."""
    return {ref_name(k): v for k, v in flatten(state[0]).items()}


def trace_flat(state) -> dict:
    """The optimizer's momentum by the reference's names."""
    return {ref_name(k): v for k, v in flatten(state[1]["trace"]).items()}


_BLOCK_LEAVES = {"attn.w_qkv": "attn.in_proj_weight", "attn.b_qkv": "attn.in_proj_bias",
                 "attn.w_out": "attn.out_proj.weight", "attn.b_out": "attn.out_proj.bias",
                 "mlp.w_fc": "mlp.c_fc.weight", "mlp.b_fc": "mlp.c_fc.bias",
                 "mlp.w_proj": "mlp.c_proj.weight", "mlp.b_proj": "mlp.c_proj.bias"}


def ref_name(name: str) -> str:
    """A leaf of the port's tree by its name in OpenAI's state dict (the
    prompt learner keeps its own). Only names are mapped: a weight the port
    holds input-major has the same norm as OpenAI's output-major one."""
    if name.startswith("prompt_learner."):
        return name
    parts = name.split(".")
    assert parts[0] == "clip", name
    tower, rest = parts[1], parts[2:]
    if rest[0] == "blocks":
        block = f"transformer.resblocks.{rest[1]}."
        if tower == "visual":
            block = "visual." + block
        leaf_name = ".".join(rest[2:])
        if leaf_name in _BLOCK_LEAVES:
            return block + _BLOCK_LEAVES[leaf_name]
        return block + leaf_name.replace(".scale", ".weight")
    prefix = "visual." if tower == "visual" else ""
    return prefix + ".".join(rest).replace(".scale", ".weight")
