"""CLIP encoders with deep prompt injection (port of
``federated_multi_modal_tpu/models/clip_model.py``).

Injection replaces rows and never grows the sequence:

* vision: the last ``n_ctx`` tokens (``n_ctx + n_extra`` with the per-image
  caption tokens, which are re-injected with every deep prompt) are
  replaced at layers ``1..K``;
* text: tokens ``[1 : 1 + n_ctx]`` are replaced at layers ``1..K``.

The text tower truncates at the last EOT position and packs ``128 // T``
prompts per row under a block-causal mask, exactly as the JAX package does,
so its attention runs through ``packed_attention_masked`` (``set_text_pack``
or ``pack=False`` turn packing off, as in the JAX package); the vision tower
runs every block through ``fused_block_residual`` with ``inference=True``
(groups of ``FMM_TPU_FUSED_NBLK > 1`` blocks through
``fused_block_group_residual``, with the deep prompts injected inside, as
the JAX package's eval tower does), and through ``fused_block_train`` or
``fused_block_train_dw`` in training, unless the JAX package's routing gates
pick another kernel (``ops/primitives.py``). A ModifiedResNet backbone's
image tower is ``models/resnet.py`` (cuDNN's convolutions, no kernel of the
port).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.utils.checkpoint

from federated_multi_modal_tpu_torch.models.params import CLIPConfig
from federated_multi_modal_tpu_torch.models.resnet import encode_image_resnet
from federated_multi_modal_tpu_torch.ops.kernels.fused_block import (
    fused_block_group_eligible,
    fused_block_group_size,
)
from federated_multi_modal_tpu_torch.ops.primitives import (
    attention_impl,
    build_block_causal_mask,
    build_causal_mask,
    l2_normalize,
    layer_norm,
    linear,
    residual_block,
    residual_block_group,
)
from federated_multi_modal_tpu_torch.utils.profiling import span, span_boundary

# -- vision tower -------------------------------------------------------------


def patchify(params_visual, cfg: CLIPConfig, images: torch.Tensor) -> torch.Tensor:
    """Patch embedding as one matmul: ``(B, H, W, 3)`` -> ``(B, grid^2,
    width)``, patches flattened in ``(ky, kx, channel)`` order."""
    B = images.shape[0]
    P = cfg.vision_patch_size
    g = cfg.grid_size
    x = images.reshape(B, g, P, g, P, 3).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, g * g, P * P * 3)
    return linear(x, params_visual["conv1"]["w"])


def _broadcast_prompt(p: torch.Tensor, batch: int, dtype) -> torch.Tensor:
    """(n_ctx, d) or (B, n_ctx, d) -> (B, n_ctx, d)."""
    p = p.to(dtype)
    if p.ndim == 2:
        p = p[None].expand(batch, *p.shape)
    return p


def block_forward(x, blk, n_head: int, mask=None, remat: bool = False,
                  inference: bool = False):
    """One residual block (``ops/primitives.py::residual_block``); with
    ``remat`` it runs under ``torch.utils.checkpoint`` (non-reentrant), as
    the JAX package wraps each block in ``jax.checkpoint``
    (``_block_fn``): its activations, the kernels' saved tensors included,
    are dropped after the forward and recomputed in the backward, so the
    block's forward kernels launch twice in a training step."""
    if remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(
            residual_block, x, blk, n_head, mask, inference=inference, use_reentrant=False)
    return residual_block(x, blk, n_head, mask, inference=inference)


def encode_image(
    params,
    cfg: CLIPConfig,
    images: torch.Tensor,
    shallow_prompts: Optional[torch.Tensor] = None,
    deep_prompts: Optional[Sequence[torch.Tensor]] = None,
    extra_tokens: Optional[torch.Tensor] = None,
    remat: bool = False,
    inference: bool = False,
) -> torch.Tensor:
    """Vision transformer forward with prompt injection.

    Args:
        params: the ``visual`` subtree.
        images: ``(B, H, W, 3)``.
        shallow_prompts: ``(n_ctx, width)`` or ``(B, n_ctx, width)`` tokens
            appended after the positional embedding.
        deep_prompts: per-layer prompts for layers ``1..len(deep_prompts)``;
            layer ``i`` replaces the trailing ``n_ctx`` rows with
            ``deep_prompts[i-1]``.
        extra_tokens: ``(B, k, width)`` per-image conditioning tokens (the
            caption token), appended after the shallow prompts and
            re-injected after every deep prompt.
        remat: each block's activations are recomputed in the backward
            instead of kept (:func:`block_forward`).
        inference: no gradient flows into this tower; every block then
            takes the whole-block inference kernel (else a train kernel).

    Returns:
        ``(B, embed_dim)`` image features (before normalization), fp32.

    Spans (``utils/profiling.py``): ``vision_tower``, and in the backward
    ``vision_tower.backward``.
    """
    with span("vision_tower"):
        params, shallow_prompts, deep_prompts, extra_tokens = span_boundary(
            "vision_tower", params, shallow_prompts, deep_prompts, extra_tokens, entry=True)
        dtype = params["conv1"]["w"].dtype
        x = patchify(params, cfg, images.to(dtype))
        B = x.shape[0]
        w = cfg.vision_width

        cls = params["class_embedding"].to(dtype).expand(B, 1, w)
        x = torch.cat([cls, x], dim=1)
        x = x + params["positional_embedding"].to(dtype)[None]

        n_ctx = 0
        if shallow_prompts is not None:
            sp = _broadcast_prompt(shallow_prompts, B, dtype)
            n_ctx = sp.shape[1]
            x = torch.cat([x, sp], dim=1)

        n_extra = 0
        if extra_tokens is not None:
            extra_tokens = extra_tokens.to(dtype)
            n_extra = extra_tokens.shape[1]
            x = torch.cat([x, extra_tokens], dim=1)

        x = layer_norm(x, params["ln_pre"])
        n_tail = n_ctx + n_extra

        deep_prompts = deep_prompts or []
        if deep_prompts and n_ctx == 0:
            raise ValueError(
                "deep_prompts require shallow_prompts: injection replaces the "
                "trailing prompt tokens, and with none the sequence would grow")
        for i, dp in enumerate(deep_prompts):
            if dp.shape[-2] != n_ctx:
                raise ValueError(
                    f"deep_prompts[{i}] has {dp.shape[-2]} rows but the shallow "
                    f"prompts define n_ctx={n_ctx}: injection replaces the "
                    "trailing prompt rows one-for-one")

        blocks = params["blocks"]
        if inference and attention_impl() == "pallas" and fused_block_group_eligible(
                B, x.shape[1], w, cfg.vision_heads, blocks[0]["mlp"]["w_fc"].shape[-1],
                deep_prompts):
            # groups of G blocks, the last one possibly shorter; the deep prompts
            # and the extra tokens are injected inside the group (under "xla" the
            # JAX package never groups: clip_model.py:220-230)
            G = fused_block_group_size()
            for s in range(0, len(blocks), G):
                flags = [1 <= i <= len(deep_prompts) for i in range(s, min(s + G, len(blocks)))]
                prompts = [deep_prompts[i - 1].to(dtype)
                           for i, f in zip(range(s, s + G), flags) if f]
                x = residual_block_group(x, blocks[s:s + G], cfg.vision_heads, flags, prompts,
                                         extra_tokens if any(flags) else None)
        else:
            for i, blk in enumerate(blocks):
                if 1 <= i <= len(deep_prompts):
                    tail = [_broadcast_prompt(deep_prompts[i - 1], B, dtype)]
                    if extra_tokens is not None:
                        tail.append(extra_tokens)
                    x = torch.cat([x[:, : x.shape[1] - n_tail], *tail], dim=1)
                x = block_forward(x, blk, cfg.vision_heads, remat=remat, inference=inference)

        pooled = layer_norm(x[:, 0, :], params["ln_post"])
        # fp32 products of the storage dtype's values, fp32 result
        out = torch.matmul(pooled.float(), params["proj"].to(dtype).float())
        return span_boundary("vision_tower", out, entry=False)[0]


def encode_image_auto(params, cfg: CLIPConfig, images: torch.Tensor, **prompt_kwargs):
    """The image tower of the backbone: :func:`encode_image` for a ViT,
    :func:`~federated_multi_modal_tpu_torch.models.resnet.encode_image_resnet`
    for a ModifiedResNet. Prompts are a ViT feature: on a ResNet any prompt
    raises ``ValueError``, ``inference`` (a kernel hint of the transformer
    blocks) has no effect, and ``remat`` recomputes the tower in the
    backward (``torch.utils.checkpoint``), as the JAX package's
    ``jax.checkpoint``."""
    if cfg.is_vit:
        return encode_image(params, cfg, images, **prompt_kwargs)
    prompts = {k: v for k, v in prompt_kwargs.items() if k not in ("remat", "inference")}
    if any(v is not None for v in prompts.values()):
        raise ValueError("Visual prompting requires a ViT backbone")
    rcfg = cfg.resnet_config()
    if prompt_kwargs.get("remat"):
        return torch.utils.checkpoint.checkpoint(
            encode_image_resnet, params, rcfg, images, use_reentrant=False)
    return encode_image_resnet(params, rcfg, images)


# -- text tower ---------------------------------------------------------------


def embed_tokens(params_text, tokens: torch.Tensor) -> torch.Tensor:
    """Token-id lookup -> ``(N, T, d)`` embeddings."""
    return params_text["token_embedding"][tokens.long()]


# P = 128 // T truncated prompts share one packed row (the JAX package's
# MXU-tile target, kept so that both packages run the same packed shapes).
TEXT_PACK_TARGET = 128

# Module default for encode_text_embedded's ``pack=None``, as in the JAX
# package (its trainer sets it from ``cfg.TPU.TEXT_PACK``, its bench from
# ``--no-pack``).
_TEXT_PACK_DEFAULT = True


def set_text_pack(enabled: bool) -> None:
    """Set whether :func:`encode_text_embedded` packs text rows when its
    caller passes ``pack=None``."""
    global _TEXT_PACK_DEFAULT
    _TEXT_PACK_DEFAULT = bool(enabled)


def text_pack_layout(n_prompts: int, T: int, pack: Optional[bool] = None) -> tuple:
    """``(P, G)``: :func:`encode_text_embedded` puts ``n_prompts`` prompts of
    ``T`` tokens ``P`` to a row in ``G`` rows; ``(1, n_prompts)`` unpacked
    (``pack`` off, or fewer than two prompts fit a row). ``pack=None`` is
    the module default (:func:`set_text_pack`)."""
    use_pack = _TEXT_PACK_DEFAULT if pack is None else pack
    P = TEXT_PACK_TARGET // T if use_pack else 1
    if P < 2:
        return 1, n_prompts
    G = -(-n_prompts // P)
    if G >= 8:
        # the JAX package rounds the packed-row count to a multiple of 4
        # for its 4-row kernel steps; kept so both run the same shapes
        G = -(-G // 4) * 4
    return P, G


def encode_text_embedded(
    params,
    cfg: CLIPConfig,
    prompts: torch.Tensor,
    eot_index: torch.Tensor,
    deep_prompts: Optional[Sequence[torch.Tensor]] = None,
    remat: bool = False,
    max_len: Optional[int] = None,
    pack: Optional[bool] = None,
) -> torch.Tensor:
    """Text transformer over assembled prompt embeddings ``(N, 77, d)``:
    add positions, run the causal blocks with deep prompts, LayerNorm,
    pool at ``eot_index``, project -> ``(N, embed_dim)`` fp32.

    ``max_len`` truncates the token axis (exact under the causal mask when
    every EOT lies before it: pass ``PromptConstants.text_len``). With
    ``pack`` on (``None``: the module default, see :func:`set_text_pack`)
    and ``128 // T >= 2``, that many sequences share one row under a
    block-causal mask (the same per-sequence math, in attention-sized
    rows); with it off, every sequence is its own row under a causal
    mask. ``remat`` recomputes each block in the backward
    (:func:`block_forward`). Spans: ``text_tower``, and in the backward
    ``text_tower.backward``."""
    with span("text_tower"):
        params, prompts, deep_prompts = span_boundary(
            "text_tower", params, prompts, deep_prompts, entry=True)
        if max_len is not None and prompts.shape[1] > max_len:
            prompts = prompts[:, :max_len]
        dtype = params["text_projection"].dtype
        pos = params["positional_embedding"][: prompts.shape[1]]
        x = prompts.to(dtype) + pos.to(dtype)[None]

        N, T, d = x.shape
        P, G = text_pack_layout(N, T, pack)
        deep_prompts = deep_prompts or []
        if P >= 2:
            n_pad = G * P
            if n_pad != N:
                x = torch.cat([x, x.new_zeros(n_pad - N, T, d)], dim=0)
            mask = build_block_causal_mask(P, T, device=x.device)
            x = x.reshape(G, P * T, d)
        else:
            n_pad = N
            mask = build_causal_mask(T, device=x.device)

        for i, blk in enumerate(params["blocks"]):
            if 1 <= i <= len(deep_prompts):
                p = deep_prompts[i - 1]
                if p.ndim == 3 and p.shape[0] == N and n_pad != N:
                    p = torch.cat([p, p.new_zeros(n_pad - N, *p.shape[1:])], dim=0)
                p = _broadcast_prompt(p, n_pad, dtype)
                n_ctx = p.shape[1]
                xs = x.reshape(n_pad, T, d)
                xs = torch.cat([xs[:, :1], p, xs[:, 1 + n_ctx:]], dim=1)
                x = xs.reshape(x.shape)
            x = block_forward(x, blk, cfg.transformer_heads, mask, remat=remat)

        x = x.reshape(n_pad, T, d)[:N]
        x = layer_norm(x, params["ln_final"])
        pooled = x[torch.arange(N, device=x.device), eot_index.long()]
        out = torch.matmul(pooled.float(), params["text_projection"].to(dtype).float())
        return span_boundary("text_tower", out, entry=False)[0]


def encode_text_tokens(params, cfg: CLIPConfig, tokens: torch.Tensor,
                       pack: Optional[bool] = None) -> torch.Tensor:
    """Plain CLIP ``encode_text`` over ``(N, 77)`` token ids (the zero-shot
    path): EOT at the argmax, the whole context, no truncation; ``pack`` as
    in :func:`encode_text_embedded`."""
    tokens = tokens.long()
    return encode_text_embedded(params, cfg, embed_tokens(params, tokens),
                                tokens.argmax(-1), pack=pack)


# -- similarity head ----------------------------------------------------------


def cosine_logits(image_features, text_features, logit_scale,
                  max_scale: float | None = None) -> torch.Tensor:
    """``exp(logit_scale) * norm(img) @ norm(txt)^T`` in fp32, clamped at
    ``max_scale`` when given (MaPLe clamps at 100)."""
    scale = torch.exp(logit_scale.float())
    if max_scale is not None:
        scale = torch.clamp(scale, max=max_scale)
    return scale * (l2_normalize(image_features) @ l2_normalize(text_features).T)
