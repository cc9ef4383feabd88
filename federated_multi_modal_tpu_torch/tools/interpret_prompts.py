"""Interpret learned prompt vectors as nearest vocabulary words (port of
``tools/interpret_prompts.py``).

Loads a checkpoint written by either package, takes the learned ctx vectors
(and any deep text prompts), and prints the nearest token-embedding words by
Euclidean distance per context slot. Host-only: numpy over the checkpoint
and the backbone's token embedding, no device work.

Usage (from the repository root)::

    python -m federated_multi_modal_tpu_torch.tools.interpret_prompts \\
        <checkpoint_path> [--topk 5] [--backbone ViT-B/16]
"""

from __future__ import annotations

import argparse

import numpy as np

from federated_multi_modal_tpu_torch.engine.checkpoint import load_checkpoint
from federated_multi_modal_tpu_torch.models.params import load_clip_backbone
from federated_multi_modal_tpu_torch.tokenizer import get_tokenizer


def nearest_words(ctx, token_embedding, tokenizer, topk):
    """ctx (n_ctx, d); token_embedding (vocab, d)."""
    emb = np.asarray(token_embedding, np.float32)
    out = []
    for vec in np.asarray(ctx, np.float32):
        dist = np.linalg.norm(emb - vec[None], axis=1)
        idxs = np.argsort(dist)[:topk]
        words = [
            (tokenizer.decoder.get(int(i), f"<{int(i)}>"), float(dist[i]))
            for i in idxs
        ]
        out.append(words)
    return out


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("fpath", type=str, help="path to the learned prompt checkpoint")
    parser.add_argument("--topk", type=int, default=5)
    parser.add_argument("--backbone", type=str, default="ViT-B/16")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    ckpt = load_checkpoint(args.fpath)
    state = ckpt["state_dict"]

    class _M:
        class BACKBONE:
            NAME = args.backbone
            WEIGHTS_PATH = ""

    _, params = load_clip_backbone(_M)
    token_embedding = params["text"]["token_embedding"].float().numpy()
    tok = get_tokenizer()

    ctx_keys = [
        k for k in state
        if k.endswith("ctx") or "deep_text" in k or "compound_prompts_text" in k
    ]
    if not ctx_keys:
        raise SystemExit(f"No ctx-like tensors in checkpoint; keys: {sorted(state)}")

    for key in sorted(ctx_keys):
        ctx = np.asarray(state[key])
        if ctx.ndim == 3:  # class-specific ctx: average over classes
            ctx = ctx.mean(axis=0)
        print(f"\n=== {key} (shape {tuple(ctx.shape)}) ===")
        print(f"Size of token embedding: {token_embedding.shape}")
        for slot, words in enumerate(
            nearest_words(ctx, token_embedding, tok, args.topk)
        ):
            pretty = ", ".join(f"{w!r} ({d:.3f})" for w, d in words)
            print(f"ctx[{slot}] nearest: {pretty}")


if __name__ == "__main__":
    main()
