"""The kernel wrappers' launch counts, in one place.

Each routed wrapper counts its own launches (``fn.launches``, and
``fn.backward_launches`` for a wrapper with a backward kernel), adding one
where it launches its kernel and nowhere else; ``_build.LAUNCHES`` counts
the CUDA entry points beneath them. :func:`reset` and :func:`read` cover
every wrapper, so that a caller (the bench, a smoke run) can count what one
step launched.
"""

from __future__ import annotations

from federated_multi_modal_tpu_torch.ops.kernels import attention as k_attn
from federated_multi_modal_tpu_torch.ops.kernels import eva_block as k_eva
from federated_multi_modal_tpu_torch.ops.kernels import fused_block as k_block
from federated_multi_modal_tpu_torch.ops.kernels import prototypes as k_proto


def wrappers() -> dict:
    """Every kernel wrapper, by the label its counts are read under."""
    return {"K1 packed_attention_masked": k_attn.packed_attention_masked,
            "K1b packed_attention_masked_bwd": k_attn.packed_attention_masked_bwd,
            "K2 packed_attention": k_attn.packed_attention,
            "K2b packed_attention_bwd": k_attn.packed_attention_bwd,
            "K3 fused_block_train": k_block.fused_block_train,
            "K4 fused_block_train_dw": k_block.fused_block_train_dw,
            "K5 fused_block_residual": k_block.fused_block_residual,
            "K6a fused_ln_attention_residual": k_block.fused_ln_attention_residual,
            "K6b fused_ln_mlp_residual": k_block.fused_ln_mlp_residual,
            "K7 fused_ln_attention": k_block.fused_ln_attention,
            "K8 fused_attention": k_attn.fused_attention,
            "K9 fused_block_group_residual": k_block.fused_block_group_residual,
            "P1 fused_lnqkv_attention": k_proto.fused_lnqkv_attention,
            "P2 fused_lnqkv_attention_bwd_dx": k_proto.fused_lnqkv_attention_bwd_dx,
            "P3 packed4d_attention": k_proto.packed4d_attention,
            "E1 eva_block_train": k_eva.eva_block_train,
            "E2 eva_block_train_dw": k_eva.eva_block_train_dw,
            "E3 eva_block_residual": k_eva.eva_block_residual}


def reset() -> None:
    """Every wrapper's counts to 0."""
    for fn in wrappers().values():
        fn.launches = 0
        if hasattr(fn, "backward_launches"):
            fn.backward_launches = 0


def read(nonzero: bool = False) -> dict:
    """Each wrapper's launches since :func:`reset`, a backward's under
    ``"<label> (backward)"``; ``nonzero`` leaves out those at 0."""
    counts = {}
    for label, fn in wrappers().items():
        counts[label] = fn.launches
        if hasattr(fn, "backward_launches"):
            counts[label + " (backward)"] = fn.backward_launches
    return {k: v for k, v in counts.items() if v or not nonzero}
