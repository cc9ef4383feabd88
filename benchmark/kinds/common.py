"""Set-up and read-outs that the train and eval loops share."""

from __future__ import annotations

import gc
import time

import torch

from benchmark.reference import model as reference
from benchmark.traffic import generator, weights


def classnames(cfg: dict) -> list:
    return [cfg["classnames"].format(i=i) for i in range(cfg["n_classes"])]


def setup(cfg: dict, mix: dict, seed: int, device, use_captions: bool):
    """``(system module, program, inputs)``: the kernels built, the weights,
    the prompt learner and the inputs made from the seed, the program built
    from them."""
    from benchmark.system import maple as system

    system.build_kernels(device)
    sd = weights.openai_state_dict(cfg, seed, device)
    pl = weights.prompt_learner(cfg, use_captions, seed, device)
    inputs = generator.make_inputs(mix, cfg["n_classes"], seed, device)
    prog = system.build(sd, pl, cfg, classnames(cfg), use_captions, device)
    return system, prog, inputs


def peak_bytes(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def release(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def reference_model(cfg: dict, seed: int, device, use_captions: bool, quant: bool = False):
    """The plain reference on the same weights, made again from the seed."""
    reference.strict_fp32()
    sd = weights.openai_state_dict(cfg, seed, device)
    pl = weights.prompt_learner(cfg, use_captions, seed, device)
    return reference.MaPLe(sd, pl, classnames(cfg), cfg, device, quant=quant)


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


def elapsed(start: float) -> float:
    return time.perf_counter() - start
