"""The port's MaPLe eval slice against the JAX package, module by module and
as a whole, on the CPU at the Tiny width.

JAX runs with ``_ATTENTION_IMPL = "pallas"`` so that its towers reach their
Pallas kernels (in interpret mode on the CPU); every module global a test
sets is restored through ``monkeypatch``, so a JAX test file that runs
later in the same worker sees the defaults.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import federated_multi_modal_tpu.models.clip_model as jax_clip
import federated_multi_modal_tpu.ops.primitives as jax_prim
from federated_multi_modal_tpu import flagship as jax_flagship
from federated_multi_modal_tpu.engine.checkpoint import flatten_params
from federated_multi_modal_tpu.models import params as jax_params
from federated_multi_modal_tpu.ops import preprocess as jax_pre
from federated_multi_modal_tpu.tokenizer import tokenize as jax_tokenize
from federated_multi_modal_tpu.trainers import common as jax_common
from federated_multi_modal_tpu_torch import flagship as port_flagship
from federated_multi_modal_tpu_torch.engine.tree import flatten
from federated_multi_modal_tpu_torch.models import clip_model as port_clip
from federated_multi_modal_tpu_torch.models import params as port_params
from federated_multi_modal_tpu_torch.ops import preprocess as port_pre
from federated_multi_modal_tpu_torch.ops import primitives as port_prim
from federated_multi_modal_tpu_torch.tokenizer import tokenize as port_tokenize
from federated_multi_modal_tpu_torch.trainers import common as port_common
from federated_multi_modal_tpu_torch.trainers import maple as port_maple

CFG = jax_params.tiny_test_config()


def _jax_globals(mp):
    """Pin the JAX module globals these tests set, so that they are
    restored afterwards: the attention implementation, the wgrad policy
    that ``build_maple_program`` sets, and the text-packing default."""
    mp.setattr(jax_prim, "_ATTENTION_IMPL", "pallas")
    mp.setattr(jax_prim, "_VISION_ATTN_WGRAD_BLOCKS",
               jax_prim._VISION_ATTN_WGRAD_BLOCKS)
    mp.setattr(jax_clip, "_TEXT_PACK_DEFAULT", True)


@pytest.fixture
def pallas_impl(monkeypatch):
    _jax_globals(monkeypatch)


@pytest.fixture(scope="module")
def tiny_fp32():
    """Tiny CLIP weights in fp32 (no dtype policy), in both packages."""
    jp = jax_params.init_clip_params(CFG, jax.random.PRNGKey(1), dtype_policy=False)
    return jp, port_params.load_jax_params(flatten_params(jp), device="cpu")


def test_configs_match_jax():
    for name, cfg in port_params.BACKBONE_CONFIGS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            jax_params.BACKBONE_CONFIGS[name]), name


def test_tokenizer_matches_jax():
    texts = ["a photo of a class 999.", "Storage_tank, harbor & río!",
             "a photo of a parking lot.", "", "x" * 70]
    np.testing.assert_array_equal(port_tokenize(texts), jax_tokenize(texts))


def test_load_jax_params_keeps_bf16():
    """``ml_dtypes`` bf16 leaves cross through fp32, exactly."""
    a = (np.random.default_rng(0).standard_normal((3, 5)) * 7).astype(jnp.bfloat16)
    tree = port_params.load_jax_params(
        {"text.blocks.1.attn.w_qkv": a, "logit_scale": np.float32(2.5)},
        device="cpu")
    got = tree["text"]["blocks"][1]["attn"]["w_qkv"]
    assert tree["text"]["blocks"][0] is None
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), a.astype(np.float32))


def test_encode_text_embedded_matches_jax(pallas_impl, tiny_fp32):
    """Packed text tower with deep prompts, fp32. 41 prompts of 24 tokens
    pack 5 to a row: 9 rows, rounded up to 12. Tolerance 2e-5, as the
    whole-block kernel's fp32 test: three fp32 blocks whose sums run in
    other orders than XLA's."""
    jp, tp = tiny_fp32
    rng = np.random.default_rng(5)
    N, d, n_ctx = 41, CFG.transformer_width, 2
    prompts = (rng.standard_normal((N, 77, d)) * 0.1).astype(np.float32)
    eot = rng.integers(4, 24, N).astype(np.int32)
    deep = [(rng.standard_normal((n_ctx, d)) * 0.1).astype(np.float32)
            for _ in range(2)]

    ref = jax_clip.encode_text_embedded(
        jp["text"], CFG, jnp.asarray(prompts), jnp.asarray(eot),
        deep_prompts=[jnp.asarray(p) for p in deep], max_len=24)
    got = port_clip.encode_text_embedded(
        tp["text"], CFG, torch.from_numpy(prompts), torch.from_numpy(eot),
        deep_prompts=[torch.from_numpy(p) for p in deep], max_len=24)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


def test_encode_image_inference_matches_jax(pallas_impl, tiny_fp32):
    """Vision tower on its inference path (every block through the
    whole-block kernel) with shallow and deep prompts, fp32. Tolerance
    2e-5 as the text tower's."""
    jp, tp = tiny_fp32
    rng = np.random.default_rng(6)
    w, n_ctx = CFG.vision_width, 2
    images = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    shallow = (rng.standard_normal((n_ctx, w)) * 0.1).astype(np.float32)
    deep = [(rng.standard_normal((n_ctx, w)) * 0.1).astype(np.float32)
            for _ in range(2)]

    ref = jax_clip.encode_image(
        jp["visual"], CFG, jnp.asarray(images), shallow_prompts=jnp.asarray(shallow),
        deep_prompts=[jnp.asarray(p) for p in deep], inference=True)
    got = port_clip.encode_image(
        tp["visual"], CFG, torch.from_numpy(images),
        shallow_prompts=torch.from_numpy(shallow),
        deep_prompts=[torch.from_numpy(p) for p in deep], inference=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("max_scale", [None, 100.0])
def test_cosine_logits_matches_jax(max_scale):
    rng = np.random.default_rng(10)
    img = rng.standard_normal((5, 64)).astype(np.float32)
    txt = rng.standard_normal((7, 64)).astype(np.float32)
    scale = np.float32(5.0)  # exp(5) = 148 > 100: the clamp binds
    ref = jax_clip.cosine_logits(jnp.asarray(img), jnp.asarray(txt),
                                 jnp.asarray(scale), max_scale=max_scale)
    got = port_clip.cosine_logits(torch.from_numpy(img), torch.from_numpy(txt),
                                  torch.tensor(scale), max_scale=max_scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


def test_short_text_rows_take_the_plain_attention(tiny_fp32):
    """T < 32 (no packing) runs the plain formulation, as the JAX package's
    XLA path, under a causal mask."""
    jp, tp = tiny_fp32
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 12, CFG.transformer_width)).astype(np.float32)
    blk_j, blk_t = jp["text"]["blocks"][0], tp["text"]["blocks"][0]
    ref = jax_prim.residual_block(jnp.asarray(x), blk_j, 2, jax_prim.build_causal_mask(12))
    got = port_prim.residual_block(torch.from_numpy(x), blk_t, 2,
                                   port_prim.build_causal_mask(12))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


def test_preprocess_matches_jax():
    """Crop, resize, flip and normalize. Both compute in fp32 and round to
    bf16 at the end; |values| < 4, where one bf16 step is at most 2**-7:
    tolerance two steps."""
    rng = np.random.default_rng(8)
    canvas = rng.integers(0, 256, (4, 40, 40, 3), np.uint8)
    boxes = np.asarray([[0, 0, 40, 40], [3, 5, 20, 31], [10, 0, 30, 17],
                        [1, 2, 9, 9]], np.float32)
    flips = np.asarray([False, True, False, True])
    ref = jax_pre.crop_resize_flip_normalize(
        jnp.asarray(canvas), jnp.asarray(boxes), jnp.asarray(flips), out_size=32)
    got = port_pre.crop_resize_flip_normalize(
        torch.from_numpy(canvas), torch.from_numpy(boxes), torch.from_numpy(flips),
        out_size=32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               atol=2 ** -6, rtol=0)
    for a, b in zip(port_pre.center_boxes(3, 40, 32), jax_pre.center_boxes(3, 40, 32)):
        np.testing.assert_array_equal(a, b)


def test_program_trees_match_jax(monkeypatch):
    """Same leaf names, shapes and dtypes in the trainable and frozen trees
    (captions on, so the caption parameters are compared too)."""
    _jax_globals(monkeypatch)
    jprog = jax_flagship.build_maple_program(backbone="Tiny", depth=3)
    tprog = port_flagship.build_maple_program(backbone="Tiny", depth=3, device="cpu")

    def summary(flat):
        return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in flat.items()}

    for part in ("trainable", "frozen"):
        jtree = jprog[part] if part == "trainable" else jprog[part]["model"]
        ttree = tprog[part] if part == "trainable" else tprog[part]["model"]
        assert summary(flatten(ttree)) == summary(flatten_params(jtree)), part
    assert tprog["text_len"] == jprog["text_len"]


@pytest.fixture(scope="module")
def jax_eval():
    """The JAX eval path on Tiny (depth 3, no captions, bf16 policy) under
    the pallas implementation: weights, constants, images and outputs."""
    with pytest.MonkeyPatch.context() as mp:
        _jax_globals(mp)
        prog = jax_flagship.build_maple_program(
            backbone="Tiny", depth=3, use_captions=False)
        rng = np.random.default_rng(9)
        canvas = rng.integers(0, 256, (4, 40, 40, 3), np.uint8)
        boxes, flips = jax_pre.center_boxes(4, 40, 32)
        images = jax_pre.crop_resize_flip_normalize(
            jnp.asarray(canvas), jnp.asarray(boxes), jnp.asarray(flips), out_size=32)
        prep = jax.jit(prog["eval_prepare_fn"])(prog["trainable"], prog["frozen"])
        logits = jax.jit(prog["eval_apply_fn"])(
            prog["trainable"], prog["frozen"], images, prep)
        const = jax_common.build_prompt_constants(
            prog["frozen"]["model"]["clip"]["text"], jax_flagship.DEFAULT_CLASSNAMES,
            "a photo of a", 2)
        return {
            "flat_trainable": flatten_params(prog["trainable"]),
            "flat_frozen": flatten_params(prog["frozen"]["model"]),
            "const": const, "text_len": prog["text_len"], "canvas": canvas,
            "boxes": boxes, "flips": flips,
            "txt_n": np.asarray(prep["txt_n"]), "logits": np.asarray(logits),
        }


def test_prompt_constants_match_jax(jax_eval):
    frozen = port_params.load_jax_params(jax_eval["flat_frozen"], device="cpu")
    const = port_common.build_prompt_constants(
        frozen["clip"]["text"], port_flagship.DEFAULT_CLASSNAMES, "a photo of a", 2)
    ref = jax_eval["const"]
    assert const.text_len == ref.text_len == jax_eval["text_len"]
    assert const.name_lens == ref.name_lens
    np.testing.assert_array_equal(const.tokenized.numpy(), np.asarray(ref.tokenized))
    np.testing.assert_array_equal(const.eot_index.numpy(), np.asarray(ref.eot_index))
    for name in ("token_prefix", "token_suffix"):
        np.testing.assert_array_equal(
            getattr(const, name).float().numpy(),
            np.asarray(getattr(ref, name), np.float32))


# Whole-slice tolerances (bf16 path: both sides round at the same points but
# sum in other orders). The largest errors read on the CPU at the seeds
# below are 0.00407 on the normalized text features (|values| up to 0.337,
# where one bf16 step is 2**-9 = 0.00195) and 0.0499 on the logits (|values|
# up to 1.82 at scale 14.29: 0.0035 in cosine). Each bound is about twice
# that. The planted faults below move them by 0.14 to 0.24 and 1.3 to 2.6.
TOL_TXT_N = 8e-3
TOL_LOGITS = 0.1


def _port_eval(jax_eval):
    """The port's eval path on JAX's weights (carried across with
    ``load_jax_params``): preprocessing, ``eval_prepare_fn`` and
    ``eval_apply_fn``. Returns the normalized text features and logits."""
    trainable = port_params.load_jax_params(jax_eval["flat_trainable"], device="cpu")
    frozen_model = port_params.load_jax_params(jax_eval["flat_frozen"], device="cpu")
    const = port_common.build_prompt_constants(
        frozen_model["clip"]["text"], port_flagship.DEFAULT_CLASSNAMES,
        "a photo of a", 2)
    frozen = {"model": frozen_model, "prompt_const": {
        "token_prefix": const.token_prefix, "token_suffix": const.token_suffix,
        "eot_index": const.eot_index}}
    prog = port_flagship.build_maple_program(
        backbone="Tiny", depth=3, use_captions=False, device="cpu")

    images = port_pre.crop_resize_flip_normalize(
        torch.from_numpy(jax_eval["canvas"]), torch.from_numpy(jax_eval["boxes"]),
        torch.from_numpy(jax_eval["flips"]), out_size=32)
    prep = prog["eval_prepare_fn"](trainable, frozen)
    logits = prog["eval_apply_fn"](trainable, frozen, images, prep)
    return prep["txt_n"].numpy(), logits.numpy()


def test_eval_path_matches_jax(jax_eval):
    """The whole slice against JAX, at ``TOL_TXT_N`` and ``TOL_LOGITS``."""
    txt_n, logits = _port_eval(jax_eval)
    np.testing.assert_allclose(txt_n, jax_eval["txt_n"], atol=TOL_TXT_N, rtol=0)
    assert logits.shape == jax_eval["logits"].shape
    np.testing.assert_allclose(logits, jax_eval["logits"], atol=TOL_LOGITS, rtol=0)


def _rotate_deep_prompts(real):
    def maple_prompts(*args):
        prompts, shared_ctx, text_deep, vis_deep = real(*args)
        return prompts, shared_ctx, text_deep[1:] + text_deep[:1], vis_deep[1:] + vis_deep[:1]
    return maple_prompts


def _eot_one_early(real):
    def build_prompt_constants(*args):
        const = real(*args)
        return dataclasses.replace(const, eot_index=const.eot_index - 1)
    return build_prompt_constants


@pytest.mark.parametrize("module, name, fault", [
    (port_maple, "maple_prompts", _rotate_deep_prompts),
    (port_common, "build_prompt_constants", _eot_one_early),
], ids=["deep_prompts_at_wrong_layers", "eot_index_one_early"])
def test_eval_path_comparison_sees_planted_faults(jax_eval, monkeypatch, module,
                                                  name, fault):
    """A planted fault in the port's path must break the whole-slice
    comparison at its tolerances: the deep prompts injected at each other's
    layers, or the text feature pooled one token before EOT."""
    monkeypatch.setattr(module, name, fault(getattr(module, name)))
    txt_n, logits = _port_eval(jax_eval)
    assert (np.abs(txt_n - jax_eval["txt_n"]).max() > TOL_TXT_N
            and np.abs(logits - jax_eval["logits"]).max() > TOL_LOGITS)
