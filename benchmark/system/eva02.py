"""The system under test for EVA02-CLIP: the port's MaPLe program as
``benchmark/system/maple.py`` drives it (the port's loader, which reads
EVA-CLIP's keys, the program's assembly, the engine's captured train step
and eval), with the port's leaves named as EVA-CLIP's state dict names them
for the comparison: ``w_qkv`` split into q, k and v, the interleaved and
``w12`` and ``b12`` split into W1 and W2. The hidden's padding (2730 to 2736
columns of ``w12``, ``b12``, ``ln_ffn`` and ``w3``) is zero and stays zero,
so a leaf's norm is its published part's."""

from __future__ import annotations

from benchmark.system import maple
from benchmark.system.maple import _BLOCK_LEAVES
from benchmark.system.maple import (  # noqa: F401
    Runner,
    build,
    eval_step,
    leaf,
    optimizer,
    train_step,
)
from federated_multi_modal_tpu_torch.engine.tree import flatten

def build_kernels(device) -> None:
    """``maple.build_kernels`` once the port is known to read EVA-CLIP's
    weights: a program without the EVA block fails here, before the build."""
    from federated_multi_modal_tpu_torch.models.params import infer_eva_config  # noqa: F401

    maple.build_kernels(device)


_LN = {"ln_1": "norm1", "ln_2": "norm2", "attn.ln_inner": "attn.inner_attn_ln",
       "mlp.ln_ffn": "mlp.ffn_ln"}
_SIMPLE = {"attn.q_bias": "attn.q_bias", "attn.v_bias": "attn.v_bias",
           "attn.w_out": "attn.proj.weight", "attn.b_out": "attn.proj.bias",
           "mlp.b3": "mlp.w3.bias"}


def _vision_block(prefix: str, rest: str, t) -> dict:
    D = t.shape[0]
    for port, eva in _LN.items():
        if rest.startswith(port + "."):
            kind = "weight" if rest.endswith(".scale") else "bias"
            return {f"{prefix}{eva}.{kind}": t}
    if rest in _SIMPLE:
        return {prefix + _SIMPLE[rest]: t}
    if rest == "attn.w_qkv":
        return {f"{prefix}attn.{n}_proj.weight": t[:, i * D:(i + 1) * D] for i, n in enumerate("qkv")}
    if rest in ("mlp.w12", "mlp.b12"):
        pair = t.reshape(*t.shape[:-1], -1, 2)
        kind = "weight" if rest == "mlp.w12" else "bias"
        return {f"{prefix}mlp.w1.{kind}": pair[..., 0], f"{prefix}mlp.w2.{kind}": pair[..., 1]}
    if rest == "mlp.w3":
        return {prefix + "mlp.w3.weight": t}
    raise KeyError(rest)


def ref_names(flat: dict) -> dict:
    """The port's flat leaves (``clip.*``, ``prompt_learner.*``) by EVA-CLIP's
    names (the prompt learner keeps its own). A weight the port holds
    input-major has the norm of EVA's output-major one."""
    out = {}
    for name, t in flat.items():
        if name.startswith("prompt_learner."):
            out[name] = t
            continue
        parts = name.split(".")
        tower, rest = parts[1], parts[2:]
        if tower == "visual" and rest[0] == "blocks":
            out.update(_vision_block(f"visual.blocks.{rest[1]}.", ".".join(rest[2:]), t))
        elif tower == "visual":
            out["visual." + {"ln_post.scale": "norm.weight", "ln_post.bias": "norm.bias",
                             "proj": "head.weight", "proj_bias": "head.bias"}[".".join(rest)]] = t
        elif rest[0] == "blocks":
            leaf_name = ".".join(rest[2:])
            block = f"text.transformer.resblocks.{rest[1]}."
            out[block + _BLOCK_LEAVES.get(leaf_name, leaf_name.replace(".scale", ".weight"))] = t
        else:
            out["text." + ".".join(rest).replace(".scale", ".weight")] = t
    return out


def trainable_flat(state) -> dict:
    """The trainable leaves by the reference's names."""
    return ref_names(flatten(state[0]))


def trace_flat(state) -> dict:
    """The optimizer's momentum by the reference's names."""
    return ref_names(flatten(state[1]["trace"]))
