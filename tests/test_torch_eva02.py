"""EVA02-CLIP-L/14 on the port, held to the plain float32 reference
``tests/eva02_reference.py`` on the CPU at a small size: width 128 (two heads
of 64), patch 8 at 48 pixels (a 6 x 6 grid, 39 rows with MaPLe's two prompt
rows and the caption row: past the kernel routes' 32), a SwiGLU hidden of 341
(padded to 344, not a multiple of 8), three vision and two text blocks.

On the CPU the kernel routes run their plain steps (``eva_block.EVA_PLAIN_STEPS``);
the card's kernels are held to those in ``tests/test_torch_cuda.py``.
"""

import math

import pytest
import torch

from federated_multi_modal_tpu_torch import flagship
from federated_multi_modal_tpu_torch.engine.tree import (
    cast_tree,
    flatten,
    merge_trees,
    tree_map_with_path,
    unflatten,
)
from federated_multi_modal_tpu_torch.models import clip_model as CM
from federated_multi_modal_tpu_torch.models import params as P
from federated_multi_modal_tpu_torch.ops import primitives as prim
from federated_multi_modal_tpu_torch.ops.kernels import counters
from federated_multi_modal_tpu_torch.ops.kernels import eva_block as EB
from federated_multi_modal_tpu_torch.tokenizer.bpe import tokenize
from federated_multi_modal_tpu_torch.trainers.maple import maple_trainable_predicate
from tests import eva02_reference as R

NAME = "EVA02-CLIP-L/14"
CFG = P.eva02_config(embed_dim=64, image_resolution=48, vision_layers=3, vision_width=128,
                     vision_patch_size=8, transformer_width=128, transformer_heads=2,
                     transformer_layers=2, vision_mlp_width=341)
CLASSNAMES = [f"class {i}" for i in range(5)]
DEPTH, N_CTX, B = 3, 2, 4


@pytest.fixture(autouse=True)
def _pallas():
    saved = prim.attention_impl()
    prim.set_attention_impl("pallas")
    yield
    prim.set_attention_impl(saved)


def _images(seed, n=B):
    g = torch.Generator().manual_seed(seed)
    # values the port's bf16 weights meet exactly: the reference reads the same
    return torch.randn(n, 48, 48, 3, generator=g).to(torch.bfloat16).float()


def _rel(got, ref):
    got, ref = got.detach(), ref.detach()
    return float((got.double() - ref.double()).norm() / ref.double().norm().clamp(min=1e-30))


# -- the rotary table -----------------------------------------------------------------


def test_rope_table_is_evas_formula_on_the_patch_rows_only():
    grid, hd, T = 6, 64, 40
    table = EB.rope_table(T, grid, hd)
    cos, sin = R.rope_cos_sin(grid, hd)
    assert table.shape == (T, hd // 2, 2)
    # EVA's table repeats each pair's angle; the port keeps one a pair
    assert torch.equal(cos[:, 0::2], cos[:, 1::2]) and torch.equal(sin[:, 0::2], sin[:, 1::2])
    assert torch.allclose(table[1:1 + grid * grid, :, 0], cos[:, 0::2], atol=1e-6)
    assert torch.allclose(table[1:1 + grid * grid, :, 1], sin[:, 0::2], atol=1e-6)
    # CLS and the rows after the patches (prompts, caption) are the identity
    for rows in (table[:1], table[1 + grid * grid:]):
        assert torch.equal(rows[..., 0], torch.ones_like(rows[..., 0]))
        assert torch.equal(rows[..., 1], torch.zeros_like(rows[..., 1]))
    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, T, 2 * hd, generator=g)
    got = EB.apply_rope(q, table)
    heads = q.reshape(2, T, 2, hd).transpose(1, 2)
    mid = heads[:, :, 1:1 + grid * grid]
    want = torch.cat([heads[:, :, :1], mid * cos + R.rotate_half(mid) * sin,
                      heads[:, :, 1 + grid * grid:]], 2).transpose(1, 2).reshape(2, T, 2 * hd)
    assert torch.allclose(got, want, atol=1e-5)
    assert torch.equal(got[:, 0], q[:, 0]) and torch.equal(got[:, 1 + grid * grid:],
                                                           q[:, 1 + grid * grid:])
    # theta then -theta gives the input back (fp32 round-off alone)
    assert torch.allclose(EB.apply_rope(got, table, inverse=True), q, atol=1e-5)
    # the port's plain rope_rows turns q and k and leaves v
    qkv = torch.randn(2, T, 3 * hd, generator=g)
    turned = EB.rope_rows_reference(qkv, table)
    assert torch.allclose(turned[..., :2 * hd], EB.apply_rope(qkv[..., :2 * hd], table))
    assert torch.equal(turned[..., 2 * hd:], qkv[..., 2 * hd:])


# -- the state dict -----------------------------------------------------------------------


def _eva_state_dict(seed=0):
    """A state dict under EVA-CLIP's published key names, with the rotary
    buffers the published checkpoint carries."""
    params = P.init_clip_params(CFG, torch.Generator().manual_seed(seed), dtype_policy=False)
    sd = P.export_eva_state_dict(params, CFG)
    cos, sin = R.rope_cos_sin(CFG.grid_size, 64)
    sd["visual.rope.freqs_cos"], sd["visual.rope.freqs_sin"] = cos, sin
    return sd


def test_config_is_inferred_from_evas_keys():
    sd = _eva_state_dict()
    for key in ("visual.patch_embed.proj.weight", "visual.blocks.0.attn.q_proj.weight",
                "visual.blocks.0.attn.q_bias", "visual.blocks.0.attn.inner_attn_ln.weight",
                "visual.blocks.2.mlp.ffn_ln.bias", "visual.blocks.0.mlp.w3.weight",
                "visual.head.bias", "text.transformer.resblocks.1.mlp.c_fc.weight"):
        assert key in sd, key
    assert "visual.blocks.0.attn.k_bias" not in sd
    assert sd["visual.blocks.0.mlp.w1.weight"].shape == (341, 128)
    assert P.infer_config_from_state_dict(sd) == CFG
    assert P.BACKBONE_CONFIGS[NAME] == P.eva02_config()
    full = P.BACKBONE_CONFIGS[NAME]
    assert (full.vision_mlp_width, full.vision_mlp_padded, full.vision_heads) == (2730, 2736, 16)
    assert P.is_eva(full) and not P.is_eva(P.BACKBONE_CONFIGS["ViT-L/14"])


def test_converter_round_trips_evas_keys_and_pads_the_hidden():
    sd = _eva_state_dict()
    tree = P.convert_torch_state_dict(sd)
    blk = tree["visual"]["blocks"][1]
    assert blk["mlp"]["w12"].shape == (128, 2 * 344) and blk["mlp"]["w3"].shape == (344, 128)
    w1, w2 = P.split_gate(blk["mlp"]["w12"].float(), 341)
    assert torch.equal(w1, sd["visual.blocks.1.mlp.w1.weight"].T.to(torch.bfloat16).float())
    assert torch.equal(w2, sd["visual.blocks.1.mlp.w2.weight"].T.to(torch.bfloat16).float())
    # the padding is zero, the sub-LNs fp32 under the dtype policy
    assert not blk["mlp"]["w12"].reshape(128, 344, 2)[:, 341:].any()
    assert not blk["mlp"]["w3"][341:].any() and not blk["mlp"]["ln_ffn"]["scale"][341:].any()
    assert blk["mlp"]["ln_ffn"]["scale"].dtype == torch.float32
    assert blk["attn"]["ln_inner"]["bias"].dtype == torch.float32
    assert blk["attn"]["w_qkv"].dtype == torch.bfloat16
    back = P.export_eva_state_dict(P.convert_torch_state_dict(sd, dtype_policy=False), CFG)
    want = {k: v for k, v in sd.items() if "rope.freqs" not in k}
    assert set(back) == set(want)
    for k, v in want.items():
        assert torch.equal(back[k], v.float()), k


def test_sub_layernorms_are_layernorms_to_the_policy_and_maple():
    params = P.init_clip_params(CFG, torch.Generator().manual_seed(1))
    flat = flatten(params)
    pred = maple_trainable_predicate(CFG.vision_layers, CFG.transformer_layers)
    for name, t in flat.items():
        norm = any(s in name for s in (".ln_inner.", ".ln_ffn.", ".ln_1.", ".ln_2.", "ln_post",
                                       "ln_final"))
        assert (t.dtype == torch.float32) == (norm or name == "logit_scale"), name
        last = name.startswith(("visual.blocks.2.", "text.blocks.1."))
        assert pred("clip." + name) == (norm or last), name


# -- the towers in fp32: the route's sequence against EVA's equations ------------------


def _fp32_visual():
    params = P.init_clip_params(CFG, torch.Generator().manual_seed(2), dtype_policy=False)
    return params, P.export_eva_state_dict(params, CFG)


@pytest.mark.parametrize("route", ["kernel", "xla"])
def test_image_tower_in_fp32_matches_the_reference(route):
    """fp32 weights and activations on both sides: the port's sequence (the
    kernel route's plain steps, or the plain formulation) and EVA's code differ
    by the order of fp32 sums alone, so features and gradients agree to
    1e-4 of their norms."""
    prim.set_attention_impl("pallas" if route == "kernel" else "xla")
    params, sd = _fp32_visual()
    g = torch.Generator().manual_seed(4)
    images = _images(5)
    shared = torch.randn(N_CTX, 128, generator=g) * 0.5
    deep = [torch.randn(N_CTX, 128, generator=g) * 0.5]
    extra = torch.randn(B, 1, 128, generator=g) * 0.5
    cot = torch.randn(B, 64, generator=g)

    flat = {k: v.clone().requires_grad_("ln_" in k or k.startswith("blocks.2."))
            for k, v in flatten(params["visual"]).items()}
    out = CM.encode_image(unflatten(flat), CFG, images, shallow_prompts=shared,
                          deep_prompts=deep, extra_tokens=extra)
    (out * cot).sum().backward()

    R.strict_fp32()
    ref_sd = {k: v.clone().requires_grad_(True) for k, v in sd.items()}
    ref = R.encode_image(ref_sd, images.permute(0, 3, 1, 2), shared, deep, extra)
    (ref * cot).sum().backward()
    assert _rel(out, ref) < 1e-4
    grads = unflatten({k: v.grad if v.grad is not None else torch.zeros_like(v)
                       for k, v in flat.items()})
    port_g = P.export_eva_state_dict(dict(params, visual=grads), CFG)
    checked = 0
    for k, t in ref_sd.items():
        if not k.startswith("visual.") or port_g[k].abs().sum() == 0:
            continue
        assert _rel(port_g[k], t.grad) < 1e-4, k
        checked += 1
    # every block's four LayerNorms, the last block's 13 weights, the final norm
    assert checked == 3 * 8 + 13 + 2, checked


# -- the MaPLe program in bf16 against the reference ---------------------------------------


@pytest.fixture
def eva_program(monkeypatch):
    monkeypatch.setitem(P.BACKBONE_CONFIGS, NAME, CFG)

    def build(remat=False):
        return flagship.build_maple_program(backbone=NAME, classnames=CLASSNAMES, depth=DEPTH,
                                            n_ctx=N_CTX, remat=remat, seed=3, device="cpu")
    return build


def _batch(seed):
    g = torch.Generator().manual_seed(seed)
    captions = torch.from_numpy(tokenize([f"a photo of thing {i}" for i in range(B)])).long()
    return {"image": _images(seed), "label": torch.randint(0, len(CLASSNAMES), (B,), generator=g),
            "caption_tokens": captions}


def _port_loss_and_grads(prog, batch):
    trainable = tree_map_with_path(lambda _, t: t.detach().clone().requires_grad_(True),
                                   prog["trainable"])
    loss, _ = prog["loss_fn"](trainable, prog["frozen"], batch)
    loss.backward()
    return float(loss.detach()), tree_map_with_path(lambda _, t: t.grad, trainable)


def _reference(prog):
    clip = merge_trees(prog["trainable"]["clip"], prog["frozen"]["model"]["clip"])
    sd = P.export_eva_state_dict(clip, CFG)
    pl = {k: v for k, v in flatten(prog["trainable"]["prompt_learner"]).items()}
    ids = torch.from_numpy(tokenize([f"a photo of a {c}." for c in CLASSNAMES])).long()
    return R.EvaMaple(sd, pl, ids, ids.argmax(-1), N_CTX, DEPTH, prog["text_len"], 0.5)


def _grads_by_reference_name(prog, grads):
    """The port's gradient tree under the reference's names: the clip part
    through the converter's inverse (zeros where the port trains nothing)."""
    frozen = tree_map_with_path(lambda _, t: torch.zeros_like(t, dtype=torch.float32),
                                prog["frozen"]["model"]["clip"])
    sd = P.export_eva_state_dict(merge_trees(grads["clip"], frozen), CFG)
    out = {k: v for k, v in sd.items()}
    out.update({"prompt_learner." + k: v for k, v in flatten(grads["prompt_learner"]).items()})
    return out


# (gradient gap, loss, eval logits) limits by precision. fp32: the program on
# fp32 weights runs every product in fp32, so it differs from the reference
# by the order of sums alone. bf16 (the program as it runs): bf16 products and
# frozen weights round the features to ~2**-8, and MaPLe's logit scale of 100
# turns the cosines' ~1e-3 into ~0.1 of a logit and ~7 % of every leaf's
# gradient, the text tower's (CLIP's code) as much as the vision tower's.
LIMITS = {"fp32": (1e-3, 1e-5, 1e-3), "bf16": (0.15, 1e-2, 0.25)}


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_maple_program_matches_the_reference(eva_program, precision):
    """The program's loss, the gradient of every trainable leaf (its gap as
    the benchmark's ``grad_gap`` measures it: against the larger of its norm
    and the median leaf's) and its prompt-cached eval logits against the
    reference on the same weights."""
    prog = eva_program()
    if precision == "fp32":
        prog["frozen"] = cast_tree(prog["frozen"], torch.float32)
    grad_limit, loss_limit, logit_limit = LIMITS[precision]
    batch = _batch(7)
    loss, grads = _port_loss_and_grads(prog, batch)
    ref = _reference(prog)
    R.strict_fp32()
    ref_loss, _, ref_grads = ref.loss_and_grads(batch["image"].permute(0, 3, 1, 2),
                                                batch["label"], batch["caption_tokens"])
    assert abs(loss - ref_loss) <= loss_limit * abs(ref_loss)
    got = _grads_by_reference_name(prog, grads)
    norms = sorted(float(g.norm()) for g in ref_grads.values())
    floor = norms[len(norms) // 2]
    for k, g in ref_grads.items():
        # a leaf the loss does not reach (proj_vis_to_lang, a coupler past the
        # text tower's depth) has no gradient in the port and zeros here
        mine = got[k].float() if got.get(k) is not None else torch.zeros_like(g)
        gap = float((mine - g).norm()) / max(float(g.norm()), floor)
        assert gap < grad_limit, (k, gap)
    # the gradients of the hidden's padding are zero
    w12 = grads["clip"]["visual"]["blocks"][2]["mlp"]["w12"]
    assert not w12.reshape(128, 344, 2)[:, 341:].any()
    assert not grads["clip"]["visual"]["blocks"][0]["mlp"]["ln_ffn"]["scale"][341:].any()

    prep = prog["eval_prepare_fn"](prog["trainable"], prog["frozen"])
    logits = prog["eval_apply_fn"](prog["trainable"], prog["frozen"], batch["image"], prep)
    ref_logits = ref.logits(batch["image"].permute(0, 3, 1, 2))
    assert float((logits - ref_logits).abs().max()) < logit_limit


def test_remat_gives_the_same_loss_and_gradients(eva_program):
    batch = _batch(8)
    loss, grads = _port_loss_and_grads(eva_program(), batch)
    loss_r, grads_r = _port_loss_and_grads(eva_program(remat=True), batch)
    assert loss == loss_r
    for k, g in flatten(grads).items():
        assert torch.equal(g, flatten(grads_r)[k]), k


def test_every_vision_block_takes_an_eva_route(eva_program, monkeypatch):
    """A train step: every frozen block through ``eva_block_train`` and the
    last through ``eva_block_train_dw``, each backward through the block's
    own, and no block on the plain formulation; the eval: every block
    through ``eva_block_residual``."""
    calls = {"train": 0, "train_dw": 0, "residual": 0, "backward": 0, "plain": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    for name in ("train", "train_dw", "residual"):
        monkeypatch.setattr(EB, f"eva_block_{name}", counting(name, getattr(EB, f"eva_block_{name}")))
    monkeypatch.setattr(prim, "eva_attention", counting("plain", prim.eva_attention))
    monkeypatch.setattr(EB, "eva_block_backward", counting("backward", EB.eva_block_backward))
    prog = eva_program()
    _port_loss_and_grads(prog, _batch(9))
    L = CFG.vision_layers
    assert calls == {"train": L - 1, "train_dw": 1, "residual": 0, "backward": L, "plain": 0}
    prep = prog["eval_prepare_fn"](prog["trainable"], prog["frozen"])
    prog["eval_apply_fn"](prog["trainable"], prog["frozen"], _images(9), prep)
    assert calls["residual"] == L and calls["plain"] == 0
    assert {"E1 eva_block_train", "E2 eva_block_train_dw",
            "E3 eva_block_residual"} <= set(counters.wrappers())


def test_text_tower_takes_exact_gelu():
    """OpenCLIP's text MLP (EVA-CLIP's) is exact GELU; OpenAI's QuickGELU."""
    g = torch.Generator().manual_seed(11)
    blk = P.init_clip_params(P.tiny_test_config(), g, dtype_policy=False)["text"]["blocks"][0]
    x = torch.randn(2, 40, 128, generator=g)
    mask = prim.build_causal_mask(40)
    exact = prim.residual_block(x, blk, 2, mask, quick_gelu_mlp=False)
    quick = prim.residual_block(x, blk, 2, mask)
    h = prim.layer_norm(x + prim.multi_head_attention(prim.layer_norm(x, blk["ln_1"]),
                                                      blk["attn"], 2, mask), blk["ln_2"])
    y = x + prim.multi_head_attention(prim.layer_norm(x, blk["ln_1"]), blk["attn"], 2, mask)
    fc = prim.linear(h, blk["mlp"]["w_fc"], blk["mlp"]["b_fc"])
    want = y + prim.linear(torch.nn.functional.gelu(fc), blk["mlp"]["w_proj"],
                           blk["mlp"]["b_proj"])
    assert torch.allclose(exact, want, atol=1e-5)
    assert not torch.allclose(exact, quick, atol=1e-4)
    assert math.isfinite(float(exact.sum()))
