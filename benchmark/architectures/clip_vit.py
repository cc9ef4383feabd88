"""OpenAI's CLIP ViT with MaPLe: the architecture of a configuration that
names none.

Every piece a loop takes from its model, under the names that
``benchmark/harness.py`` lists for an architecture: the seeded weights
(``benchmark/traffic/weights.py``), the system under test
(``benchmark/system/maple.py``), the plain reference and its crop
(``benchmark/reference/model.py``) and the frozen counts
(``benchmark/counts/flops.py``). CLIP's block is pre-LN with QuickGELU and
heads of 64.
"""

from __future__ import annotations

import torch

from benchmark.counts.flops import (  # noqa: F401
    attention_work,
    eval_batch_flops,
    gemm_work,
    train_step_flops,
)
from benchmark.reference.model import MaPLe as Reference  # noqa: F401
from benchmark.reference.model import crop, grad_norm, strict_fp32  # noqa: F401
from benchmark.system import maple as system  # noqa: F401
from benchmark.traffic.weights import openai_state_dict as state_dict  # noqa: F401
from benchmark.traffic.weights import prompt_learner  # noqa: F401


def reference_rows(cfg: dict, mix: dict, device) -> int:
    """Images the reference's image tower takes at once: what fits half the
    free memory, by a rough count of float32 activations kept for the
    backward."""
    if device.type != "cuda":
        return mix["batch"]
    D, L = cfg["vision_width"], cfg["vision_layers"]
    T = (cfg["image_resolution"] // cfg["vision_patch_size"]) ** 2 + 4
    per_image = 4 * L * (40 * T * D + 4 * (D // 64) * T * T)
    free, _ = torch.cuda.mem_get_info(device)
    return max(1, min(mix["batch"], int(0.5 * free // per_image)))
