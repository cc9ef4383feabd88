"""Set-up and read-outs that the train and eval loops share. The model's
pieces come from the configuration's architecture module ``arch``
(``benchmark/architectures/``)."""

from __future__ import annotations

import gc
import time

import torch

from benchmark.traffic import generator


def classnames(cfg: dict) -> list:
    return [cfg["classnames"].format(i=i) for i in range(cfg["n_classes"])]


def setup(cfg: dict, mix: dict, arch, seed: int, device, use_captions: bool):
    """``(system module, program, inputs)``: the kernels built, the weights,
    the prompt learner and the inputs made from the seed, the program built
    from them."""
    system = arch.system
    system.build_kernels(device)
    sd = arch.state_dict(cfg, seed, device)
    pl = arch.prompt_learner(cfg, use_captions, seed, device)
    inputs = generator.make_inputs(mix, cfg["n_classes"], seed, device)
    prog = system.build(sd, pl, cfg, classnames(cfg), use_captions, device)
    return system, prog, inputs


def peak_bytes(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def release(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def reference_model(cfg: dict, arch, seed: int, device, use_captions: bool,
                    quant: bool = False):
    """The plain reference on the same weights, made again from the seed."""
    arch.strict_fp32()
    sd = arch.state_dict(cfg, seed, device)
    pl = arch.prompt_learner(cfg, use_captions, seed, device)
    return arch.Reference(sd, pl, classnames(cfg), cfg, device, quant=quant)


def elapsed(start: float) -> float:
    return time.perf_counter() - start
