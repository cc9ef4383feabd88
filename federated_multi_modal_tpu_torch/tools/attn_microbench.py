"""Attention-kernel and step-decomposition micro-benchmarks on the card (port
of ``tools/attn_microbench.py``).

Three modes, at MaPLe flagship shapes by default (ViT-B/16, B=512, T=200,
bf16):

* ``attn``: packed-QKV attention variants head to head: ``null`` (the
  chaining glue), ``xla`` (the plain formulation), ``packed`` (K2, with K2b
  for fwd+bwd), ``packed4d`` and ``packed4d_par`` (P3, ``attention_pair.cu``;
  ``dims_parallel`` is a TPU compiler hint, so both lines run the same
  kernel), ``pad208`` and ``pad256`` (K2 on tokens padded to 16 and 128, the
  padded keys masked), and ``flash``, which is PyTorch's
  ``scaled_dot_product_attention``: the library yardstick, not a port (the
  JAX tool calls jax's TPU flash kernel there).
* ``parts``: the MaPLe train step split into preprocessing, vision tower,
  text tower and the loss, forward and forward + backward.
* ``block``: one ViT block split into LN, GELU, MLP, the attention sublayer,
  the block, twelve blocks, the prompt injection, the fused LN->QKV->attention
  prototypes (P1 ``attn_fusedp``, P1 + P2 ``attn_fused``) against LN + QKV
  + K2 (``attn_path``), the tower and the patch embedding.

Timing: each line runs ``iters`` iterations chained through a data
dependency, after one warm-up run, between two CUDA events. Forward chains
feed a scalar of each output back into the input; backward chains take the
gradient of a squared loss, so the cotangent depends on the data. The
``null`` line measures the chaining glue: subtract it for an op's net time.
The block lines route as the JAX tool's do: its ``residual_block(x, p, H)``
declares no frozen weights, so every mask-free block takes
``fused_block_train_dw`` (K4); the port reads "frozen" from
``requires_grad``, so the benched block weights require a gradient.

A variant that raises prints a ``FAILED`` line and the run goes on, as in the
JAX tool; the program then exits with a non-zero code.

Usage (from the repository root):
    python -m federated_multi_modal_tpu_torch.tools.attn_microbench
    python -m federated_multi_modal_tpu_torch.tools.attn_microbench --mode parts
    python -m federated_multi_modal_tpu_torch.tools.attn_microbench --mode block \\
        [--only attn_path,attn_fused]
    ... --platform cpu   (the plain versions on the CPU: paths, not times)
"""

from __future__ import annotations

import argparse
import math
import subprocess
import sys
import time
import traceback

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM, dense bf16 (NVIDIA's data sheet, at the 700 W power limit).
PEAK_BF16_FLOPS = 989e12
GB = 4  # the prototypes' batch rows per TPU grid step; only checked here


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def device_line(device: torch.device) -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them, or
    ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


class Bench:
    """Timing and failure bookkeeping of one run."""

    def __init__(self, iters: int, device: torch.device):
        self.iters = iters
        self.device = device
        self.failed = []

    def timeit(self, run) -> float:
        """Seconds per iteration of ``run()``, which runs ``iters`` chained
        iterations and returns a scalar tensor: one warm-up call, then one
        call between CUDA events (the host clock on the CPU)."""
        run()
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            float(run())
            return (time.perf_counter() - t0) / self.iters
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / self.iters

    def fail(self, name: str, e: Exception) -> str:
        self.failed.append(name)
        traceback.print_exception(e, file=sys.stderr)
        return f"FAILED: {type(e).__name__}: {str(e)[:160]}"


# -- attention variants: f(qkv (B, T, 3D)) -> (B, T, D) -------------------------


def _heads(t, n_head):
    B, T, D = t.shape
    return t.reshape(B, T, n_head, D // n_head).transpose(1, 2)


def _xla_attn(qkv, n_head):
    """The plain formulation (``_xla_attn``): fp32 scores and softmax, ``p``
    in the storage dtype, P.V in the storage dtype."""
    B, T, D3 = qkv.shape
    D = D3 // 3
    q, k, v = (_heads(t, n_head) for t in qkv.split(D, dim=-1))
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(D // n_head)
    p = torch.softmax(s, dim=-1).to(qkv.dtype)
    return torch.matmul(p, v).transpose(1, 2).reshape(B, T, D)


def _packed_padded(tpad: int):
    """K2's forward on tokens padded to a multiple of ``tpad`` (16: 208,
    128: 256), the padded keys masked by ``attention_core``'s ``valid_T``,
    cut back to T (``_build_packed_padded``)."""
    from federated_multi_modal_tpu_torch.ops.kernels import attention as k_attn
    from federated_multi_modal_tpu_torch.ops.kernels import prototypes as k_proto

    def fwd(qkv, n_head):
        B, T, D3 = qkv.shape
        if qkv.device.type == "cpu":
            return k_proto.packed4d_attention_reference(qkv, n_head, tpad)
        Tp = _round_up(T, tpad)
        padded = torch.cat([qkv, qkv.new_zeros(B, Tp - T, D3)], dim=1)
        return k_attn.attention_core_cuda(padded, n_head, valid_T=T)[:, :T]

    return fwd


def _flash(qkv, n_head):
    """PyTorch's ``scaled_dot_product_attention``: the library yardstick."""
    B, T, D3 = qkv.shape
    D = D3 // 3
    q, k, v = (_heads(t, n_head) for t in qkv.split(D, dim=-1))
    return F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(B, T, D)


def run_attn(args, device) -> list:
    """The ``attn`` lines; returns the names of the variants that failed."""
    from federated_multi_modal_tpu_torch.ops.kernels import attention as k_attn
    from federated_multi_modal_tpu_torch.ops.kernels import prototypes as k_proto

    B, T, H, D = args.batch, args.t, args.heads, args.d
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    gen = torch.Generator(device=device).manual_seed(0)
    qkv0 = (torch.randn(B, T, 3 * D, generator=gen, device=device) * 0.02).to(dtype)
    bench = Bench(args.iters, device)
    iters = args.iters

    def fwd_chain(f):
        @torch.no_grad()
        def run():
            c = qkv0
            for _ in range(iters):
                out = f(c, H)
                # scalar contamination: a data dependency at one pass's cost
                c = c + (out.reshape(-1)[0] * 1e-30).to(c.dtype)
            return c.reshape(-1)[0]
        return run

    def bwd_chain(f):
        def run():
            c = qkv0
            for _ in range(iters):
                x = c.detach().requires_grad_(True)
                y = f(x, H).float()
                (d,) = torch.autograd.grad(0.5 * (y * y).sum(), x)
                c = c * 0.9999 + d.to(c.dtype) * 1e-6
            return c.reshape(-1)[0]
        return run

    def null(qkv, n_head):
        return qkv[..., :D] * 1.0000001

    variants = {
        "null": null,
        "xla": _xla_attn,
        "packed": k_attn.packed_attention,
        "packed4d": k_proto.packed4d_attention,
        "packed4d_par": k_proto.packed4d_attention,
        "pad208": _packed_padded(16),
        "pad256": _packed_padded(128),
        "flash": _flash,
    }
    bwd_variants = {"null": null, "xla": _xla_attn, "packed": k_attn.packed_attention,
                    "flash": _flash}

    names = args.variants.split(",") if args.variants else list(variants)
    flops_fwd = 4 * B * H * T * T * (D // H)
    print(f"# attn micro: B={B} T={T} D={D} H={H} {args.dtype} iters={iters} "
          f"fwd_gflop={flops_fwd / 1e9:.1f} dev={device_line(device)} "
          "(flash = torch SDPA, the library yardstick)", flush=True)
    base_f = base_b = 0.0
    for name in names:
        if name not in variants:
            print(f"{name:14s} (unknown)")
            continue
        try:
            tf = bench.timeit(fwd_chain(variants[name]))
        except Exception as e:  # reported, and the exit code says so
            print(f"{name:14s} fwd {bench.fail(name, e)}", flush=True)
            continue
        msg = f"{name:14s} fwd {tf * 1e3:8.2f} ms"
        if name == "null":
            base_f = tf
        else:
            eff = flops_fwd / max(tf - base_f, 1e-9) / PEAK_BF16_FLOPS
            msg += f"  (net {max(tf - base_f, 0) * 1e3:6.2f} ms, {eff * 100:4.1f}% peak)"
        if name in bwd_variants and not args.fwd_only:
            try:
                tb = bench.timeit(bwd_chain(bwd_variants[name]))
                msg += f" | fwd+bwd {tb * 1e3:8.2f} ms"
                if name == "null":
                    base_b = tb
                else:
                    msg += f" (net {max(tb - base_b, 0) * 1e3:6.2f} ms)"
            except Exception as e:
                msg += f" | bwd {bench.fail(name + ' bwd', e)}"
        print(msg, flush=True)
    return bench.failed


# -- step decomposition ------------------------------------------------------


def run_parts(args, device, backbone: str = "ViT-B/16", depth: int = 9) -> list:
    """The ``parts`` lines: MaPLe's step as ``build_maple_program`` builds it
    (its last vision block trains, so the tower takes K3 in blocks 0-10 and
    K4 in the last); returns the names of the parts that failed."""
    from federated_multi_modal_tpu_torch.engine.tree import leaves, merge_trees, tree_map_with_path
    from federated_multi_modal_tpu_torch.flagship import build_maple_program
    from federated_multi_modal_tpu_torch.models.clip_model import (
        encode_image,
        encode_text_embedded,
    )
    from federated_multi_modal_tpu_torch.ops.preprocess import (
        crop_resize_flip_normalize,
        sample_rrc_boxes_torch,
    )
    from federated_multi_modal_tpu_torch.ops.primitives import set_attention_impl
    from federated_multi_modal_tpu_torch.tokenizer import tokenize
    from federated_multi_modal_tpu_torch.trainers.maple import maple_prompts

    set_attention_impl(args.attention)
    B = args.batch
    n_cls = args.n_cls
    prog = build_maple_program(backbone, classnames=[f"class {i}" for i in range(n_cls)],
                               depth=depth, use_captions=not args.no_captions, device=device)
    arch = prog["arch"]
    out_size = arch.image_resolution
    frozen = prog["frozen"]
    trainable = tree_map_with_path(lambda _, t: t.detach().requires_grad_(True),
                                   prog["trainable"])
    rng = np.random.default_rng(0)
    canvas = torch.from_numpy(rng.integers(0, 255, (B, 256, 256, 3), np.uint8)).to(device)
    labels = torch.from_numpy(rng.integers(0, n_cls, B).astype(np.int32)).to(device)
    boxes, flips = sample_rrc_boxes_torch(torch.Generator(device=device).manual_seed(0), B)
    images0 = crop_resize_flip_normalize(canvas, boxes, flips, out_size=out_size)
    bench = Bench(args.iters, device)
    iters = args.iters
    pc = frozen["prompt_const"]
    text_len = _round_up(int(pc["eot_index"].max()) + 1, 8)

    def chain_scalar(step_scalar, carry0, grad=False):
        """Carry a tensor; each iteration perturbs it by a scalar of the
        step's result."""
        def run():
            c = carry0
            for _ in range(iters):
                with torch.set_grad_enabled(grad):
                    s = step_scalar(c)
                c = c + (s.detach() * 1e-30).to(c.dtype)
            return c.reshape(-1)[0]
        return run

    def prompts_of(tr):
        m = merge_trees(tr, frozen["model"])
        return m, maple_prompts(m["prompt_learner"], pc["token_prefix"], pc["token_suffix"],
                                depth)

    def image_features(images, tr):
        m, (_, shared_ctx, _, vis_deep) = prompts_of(tr)
        return encode_image(m["clip"]["visual"], arch, images, shallow_prompts=shared_ctx,
                            deep_prompts=vis_deep)

    def text_features(tr):
        m, (prompts, _, text_deep, _) = prompts_of(tr)
        return encode_text_embedded(m["clip"]["text"], arch, prompts, pc["eot_index"],
                                    deep_prompts=text_deep, max_len=text_len)

    def grads_scalar(loss):
        grads = torch.autograd.grad(loss, leaves(trainable), allow_unused=True)
        return sum(g.reshape(-1)[0].float() for g in grads if g is not None)

    def preproc_s(carry):
        img = crop_resize_flip_normalize(carry.to(torch.uint8), boxes, flips, out_size=out_size)
        return img.reshape(-1)[0].float()

    def vis_fwd_s(images):
        return image_features(images, trainable).reshape(-1)[0].float()

    def vis_fb_s(images):
        f = image_features(images, trainable).float()
        return grads_scalar(0.5 * (f * f).sum())

    def txt_fb_s(_images):
        f = text_features(trainable).float()
        return grads_scalar(0.5 * (f * f).sum())

    batch = {"image": images0, "label": labels}
    if not args.no_captions:
        batch["caption_tokens"] = torch.from_numpy(
            tokenize(["a satellite photo of a scene"] * B)).to(device)

    def loss_fwd_s(images):
        return prog["loss_fn"](trainable, frozen, dict(batch, image=images))[0]

    def loss_fb_s(images):
        loss = prog["loss_fn"](trainable, frozen, dict(batch, image=images))[0]
        return loss.detach() + grads_scalar(loss)

    print(f"# parts micro: {backbone} B={B} n_cls={n_cls} depth={depth} iters={iters} "
          f"attention={args.attention} dev={device_line(device)}", flush=True)
    times = {}
    for key, label, fn, carry, grad in (
            ("pre", "preproc           ", preproc_s, canvas.float(), False),
            ("vf", "vision fwd        ", vis_fwd_s, images0, False),
            ("vfb", "vision fwd+bwd    ", vis_fb_s, images0, True),
            ("tfb", "text fwd+bwd      ", txt_fb_s, images0, True),
            ("lf", "full loss fwd     ", loss_fwd_s, images0, False),
            ("lfb", "full loss fwd+bwd ", loss_fb_s, images0, True)):
        try:
            times[key] = bench.timeit(chain_scalar(fn, carry, grad))
            line = f"{label} {times[key] * 1e3:8.2f} ms"
            if key == "tfb":
                line += f"  (n_cls={n_cls})"
        except Exception as e:
            line = f"{label.strip()} {bench.fail(label.strip(), e)}"
        print(line, flush=True)
    if not bench.failed:
        print(f"# sum(preproc+loss_fb) = {(times['pre'] + times['lfb']) * 1e3:.2f} ms vs "
              f"bench full step; vision share f+b = {times['vfb'] * 1e3:.2f}, "
              f"text share f+b = {times['tfb'] * 1e3:.2f}", flush=True)
    return bench.failed


# -- one ViT block, split --------------------------------------------------------


def _bf16_tree(tree, requires_grad: bool):
    """Every floating leaf in bf16 (the JAX tool casts the whole block),
    requiring a gradient when asked (the block weights: see the module
    docstring)."""
    from federated_multi_modal_tpu_torch.engine.tree import tree_map_with_path

    return tree_map_with_path(
        lambda _, t: t.detach().to(torch.bfloat16).requires_grad_(requires_grad)
        if t.is_floating_point() else t, tree)


def _frozen(tree):
    from federated_multi_modal_tpu_torch.engine.tree import tree_map_with_path

    return tree_map_with_path(lambda _, t: t.detach(), tree)


def ln_linear(x, lnp, w, b):
    """Algebraic LN -> matmul fusion: LN(x) @ w + b without materializing
    LN(x), ``rstd * (x @ (gamma * W)) - rstd * mu * (gamma^T W) + beta^T W``;
    exact in fp32, rounded differently in bf16 (raw x enters the product)."""
    g = lnp["scale"].float()
    beta = lnp["bias"].float()
    w32 = w.float()
    wp = (g[:, None] * w32).to(x.dtype)
    s = g @ w32
    t = beta @ w32
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + 1e-5)
    y = torch.matmul(x, wp).float()
    y = rstd * y - (rstd * mu) * s + t
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def run_block(args, device, arch=None) -> list:
    """The ``block`` lines at ``arch``'s widths (default ViT-B/16); returns
    the names of the lines that failed."""
    from federated_multi_modal_tpu_torch.engine.tree import to_device
    from federated_multi_modal_tpu_torch.models.params import BACKBONE_CONFIGS, init_clip_params
    from federated_multi_modal_tpu_torch.ops import primitives as P
    from federated_multi_modal_tpu_torch.ops.kernels import attention as k_attn
    from federated_multi_modal_tpu_torch.ops.kernels import prototypes as k_proto

    P.set_attention_impl(args.attention)
    arch = arch or BACKBONE_CONFIGS["ViT-B/16"]
    B, T, D = args.batch, args.t, args.d
    H = args.heads
    gen = torch.Generator().manual_seed(0)
    params = init_clip_params(arch, gen)
    blocks = [_bf16_tree(to_device(b, device), True) for b in params["visual"]["blocks"]]
    blk = blocks[0]
    dgen = torch.Generator(device=device).manual_seed(0)

    def randn(*shape, scale=0.02):
        return (torch.randn(shape, generator=dgen, device=device) * scale).to(torch.bfloat16)

    x0 = randn(B, T, D)
    x_fc = randn(B, T, 4 * D)
    bench = Bench(args.iters, device)
    iters = args.iters
    only = args.only.split(",") if args.only else []

    def chain(f, *extra, carry=None, fb=False):
        c0 = x0 if carry is None else carry

        def run():
            c = c0
            for _ in range(iters):
                if fb:
                    xr = c.detach().requires_grad_(True)
                    y = f(xr, *extra).float()
                    (d,) = torch.autograd.grad(0.5 * (y * y).sum(), xr)
                    c = c * 0.9999 + d.to(c.dtype) * 1e-6
                else:
                    with torch.no_grad():
                        c = c * 0.9999 + f(c, *extra).to(c.dtype) * 1e-6
            return c.reshape(-1)[0].float()
        return run

    def report(name, f, *extra, fb=True, carry=None):
        if only and name not in only and not name.startswith("null"):
            return
        try:
            tf = bench.timeit(chain(f, *extra, carry=carry))
            line = f"{name:12s} fwd {tf * 1e3:8.2f} ms"
            if fb and not args.fwd_only:
                tb = bench.timeit(chain(f, *extra, carry=carry, fb=True))
                line += f" | fwd+bwd {tb * 1e3:8.2f} ms"
        except Exception as e:
            line = f"{name:12s} {bench.fail(name, e)}"
        print(line, flush=True)

    print(f"# block micro: B={B} T={T} D={D} H={H} bf16 iters={iters} "
          f"attention={args.attention} dev={device_line(device)}", flush=True)
    if only == ["patchify"]:
        _patchify_bench(args, arch, params, bench, device, B)
        return bench.failed
    report("null", lambda x: x * 1.0000001)
    report("null_fc", lambda x: x * 1.0000001, carry=x_fc)
    report("ln", lambda x, p: P.layer_norm(x, p), blk["ln_1"])
    report("gelu", P.quick_gelu, carry=x_fc)
    report("mlp", P.mlp, blk["mlp"])
    report("attn_sub", lambda x, p: P.multi_head_attention(x, p, H), blk["attn"])
    report("block", lambda x, p: P.residual_block(x, p, H), blk)

    def block_noln(x, p):
        """The block with both LayerNorms removed: the ceiling a fused
        LN + matmul kernel could reach."""
        x = x + P.multi_head_attention(x, p["attn"], H)
        return x + P.mlp(x, p["mlp"])

    report("block_noln", block_noln, blk)

    def block_lnfuse(x, p):
        qkv = ln_linear(x, p["ln_1"], p["attn"]["w_qkv"], p["attn"]["b_qkv"])
        if args.attention == "pallas":
            a = k_attn.packed_attention(qkv, H)
        else:
            a = _xla_attn(qkv, H)
        x = x + P.linear(a, p["attn"]["w_out"], p["attn"]["b_out"])
        h = P.quick_gelu(ln_linear(x, p["ln_2"], p["mlp"]["w_fc"], p["mlp"]["b_fc"]))
        return x + P.linear(h, p["mlp"]["w_proj"], p["mlp"]["b_proj"])

    report("block_lnfuse", block_lnfuse, blk)

    def attn_path_ref(x, p):
        """Today's path for the same slice: LN1, the QKV product, then K2
        (which reads QKV back from device memory; K2b in the backward)."""
        xn = P.layer_norm(x, p["ln_1"])
        qkv = P.linear(xn, p["attn"]["w_qkv"], p["attn"]["b_qkv"])
        return k_attn.packed_attention(qkv, H)

    fused_fb = k_proto.make_fused_lnqkv_attention_fb(H, GB=GB)

    def attn_path_fused(x, p):
        p = _frozen(p)  # the prototype's backward gives x's gradient only
        return fused_fb(x, p["ln_1"], p["attn"]["w_qkv"], p["attn"]["b_qkv"])

    def attn_path_fused_raw(x, p):
        return k_proto.fused_lnqkv_attention(x, p["ln_1"], p["attn"]["w_qkv"],
                                             p["attn"]["b_qkv"], H, GB=GB)

    report("attn_path", attn_path_ref, blk)
    if not only or "attn_fused" in only:
        try:
            with torch.no_grad():
                err = float((attn_path_ref(x0, blk).float()
                             - attn_path_fused(x0, blk).float()).abs().max())
            print(f"attn_fused max|diff| vs attn_path = {err:.3e} (bf16 re-rounding: the "
                  "prototype adds the QKV bias before rounding; fp32-exact on the CPU, "
                  "tests/test_torch_microbench.py)", flush=True)
        except Exception as e:
            print(f"attn_fused check {bench.fail('attn_fused check', e)}", flush=True)
    report("attn_fusedp", attn_path_fused_raw, blk, fb=False)
    report("attn_fused", attn_path_fused, blk)

    def twelve(x, bs):
        for b in bs:
            x = P.residual_block(x, b, H)
        return x

    # The JAX tool scans the twelve blocks (block12) and unrolls them
    # (block12u); PyTorch has no scan, so both lines run the same loop.
    report("block12", twelve, blocks)
    report("block12u", twelve, blocks)
    prompt = randn(2, D)

    def inject(x, p):
        pb = p[None].expand(B, *p.shape)
        return torch.cat([x[:, : T - p.shape[0]], pb], dim=1)

    report("inject", inject, prompt)
    deep8 = randn(8, 2, D)

    def twelve_injected(x, bs, dp):
        """block12u plus the tower's per-layer injection: layers 1..8 replace
        the trailing two prompt tokens."""
        for i, b in enumerate(bs):
            if 1 <= i <= dp.shape[0]:
                pb = dp[i - 1][None].expand(B, *dp.shape[1:])
                x = torch.cat([x[:, : T - pb.shape[1]], pb.to(x.dtype)], dim=1)
            x = P.residual_block(x, b, H)
        return x

    report("block12i", twelve_injected, blocks, deep8)
    if not only or "tower" in only:
        _tower_bench(args, arch, params, bench, device, B)
    if not only or "patchify" in only:
        _patchify_bench(args, arch, params, bench, device, B)
    return bench.failed


def _tower_bench(args, arch, params, bench, device, B):
    """The real ``encode_image`` with MaPLe-style shallow and deep prompts,
    forward and forward + the prompts' backward (every block on K4, as the
    JAX tool's undeclared tower)."""
    from federated_multi_modal_tpu_torch.engine.tree import to_device
    from federated_multi_modal_tpu_torch.models.clip_model import encode_image

    D = arch.vision_width
    res = arch.image_resolution
    gen = torch.Generator(device=device).manual_seed(7)
    images = (torch.randn(B, res, res, 3, generator=gen, device=device) * 0.5).to(torch.bfloat16)
    vis = to_device(_bf16_tree(params["visual"], False), device)
    vis["blocks"] = [_bf16_tree(b, True) for b in vis["blocks"]]
    sp = (torch.randn(2, D, generator=gen, device=device) * 0.02).to(torch.bfloat16)
    dp = (torch.randn(8, 2, D, generator=gen, device=device) * 0.02).to(torch.bfloat16)
    iters = bench.iters

    def make(fb):
        def run():
            c = images
            for _ in range(iters):
                if fb:
                    s = sp.detach().requires_grad_(True)
                    d = dp.detach().requires_grad_(True)
                    f = encode_image(vis, arch, c, shallow_prompts=s,
                                     deep_prompts=[d[i] for i in range(8)]).float()
                    gs, gd = torch.autograd.grad(0.5 * (f * f).sum(), [s, d])
                    out = gs.reshape(-1)[0] + gd.reshape(-1)[0]
                else:
                    with torch.no_grad():
                        out = encode_image(vis, arch, c, shallow_prompts=sp,
                                           deep_prompts=[dp[i] for i in range(8)]).reshape(-1)[0]
                c = c * 0.9999 + (out.float() * 1e-30).to(c.dtype)
            return c.reshape(-1)[0].float()
        return run

    try:
        tf = bench.timeit(make(False))
        line = f"tower        fwd {tf * 1e3:8.2f} ms"
        if not args.fwd_only:
            tb = bench.timeit(make(True))
            line += f" | fwd+bwd {tb * 1e3:8.2f} ms"
    except Exception as e:
        line = f"tower {bench.fail('tower', e)}"
    print(line, flush=True)


def _patchify_bench(args, arch, params, bench, device, B):
    """The patch embedding, net of a null pass over the images."""
    from federated_multi_modal_tpu_torch.models.clip_model import patchify

    res = arch.image_resolution
    gen = torch.Generator(device=device).manual_seed(0)
    images = (torch.randn(B, res, res, 3, generator=gen, device=device) * 0.5).to(torch.bfloat16)
    vis = {"conv1": {"w": params["visual"]["conv1"]["w"].to(device, torch.bfloat16)}}
    iters = bench.iters

    @torch.no_grad()
    def run_patch():
        c = images
        for _ in range(iters):
            out = patchify(vis, arch, c)
            c = c * 0.9999 + (out.reshape(-1)[0] * 1e-30).to(c.dtype)
        return c.reshape(-1)[0].float()

    @torch.no_grad()
    def run_null():
        c = images
        for _ in range(iters):
            c = c * 1.0000001
        return c.reshape(-1)[0].float()

    try:
        tn = bench.timeit(run_null)
        tp = bench.timeit(run_patch)
        print(f"null_img     fwd {tn * 1e3:8.2f} ms", flush=True)
        print(f"patchify     fwd {tp * 1e3:8.2f} ms  (net {max(tp - tn, 0) * 1e3:.2f})",
              flush=True)
    except Exception as e:
        print(f"patchify {bench.fail('patchify', e)}", flush=True)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", choices=["attn", "parts", "block"], default="attn")
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--t", type=int, default=200)
    p.add_argument("--d", type=int, default=768)
    p.add_argument("--heads", type=int, default=12)
    p.add_argument("--n-cls", type=int, default=1000)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    p.add_argument("--variants", default="")
    p.add_argument("--fwd-only", action="store_true")
    p.add_argument("--no-captions", action="store_true")
    p.add_argument("--attention", choices=["xla", "pallas"], default="pallas")
    p.add_argument("--platform", choices=["default", "cpu"], default="default")
    p.add_argument("--only", default="",
                   help="block mode: run only the named sub-bench(es), comma-separated "
                        "(e.g. block12u,block12i,tower)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    from federated_multi_modal_tpu_torch.device import resolve_device

    args = parse_args(argv)
    device = resolve_device("cpu" if args.platform == "cpu" else None)
    run = {"parts": run_parts, "block": run_block, "attn": run_attn}[args.mode]
    failed = run(args, device)
    if failed:
        print(f"attn_microbench: {len(failed)} line(s) FAILED: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
