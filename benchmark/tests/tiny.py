"""A benchmark root at a size the CPU holds: the repository's
``BENCHMARK.json`` and ``benchmark/`` files, plus a Tiny CLIP configuration
(widths 128, 3 blocks a tower, 32 pixels, MaPLe depth 3, 4 classes) and a
train and an eval cell over it, ``tiny_train`` and ``tiny_eval``, whose
limits sit above the Tiny program's bfloat16 readings on the CPU."""

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

# the Tiny program's readings on the CPU are a few times the full sizes'
TINY_LIMITS = {"tiny_train": {"grad_gap": 0.06, "change_gap": 0.06},
               "tiny_eval": {"logit_gap": 0.1}}


def make_root(dst: Path, batch: int = 4) -> Path:
    shutil.copytree(REPO / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "benchmark/configs/maple_vit_b16.json").read_text())
    cfg.update(name="tiny", embed_dim=64, image_resolution=32, vision_layers=3,
               vision_width=128, vision_patch_size=16, transformer_width=128,
               transformer_heads=2, transformer_layers=3, n_classes=4)
    cfg["maple"] = dict(cfg["maple"], prompt_depth=3)
    write(dst / "benchmark/configs/tiny.json", cfg)
    for cell, mix in (("tiny_train", "train_rrc_b512"), ("tiny_eval", "eval_center_b512")):
        traffic = json.loads((REPO / f"benchmark/traffic/{mix}.json").read_text())
        write(dst / f"benchmark/traffic/{cell}.json", dict(traffic, batch=batch, canvas=40))
        write(dst / f"benchmark/limits/{cell}.json",
              {k: {"limit": v} for k, v in TINY_LIMITS[cell].items()})
        bench["workloads"].append({"name": cell, "config": "tiny", "traffic": cell,
                                   "chips": 1, "why": "a CPU-sized cell for tests"})
    bench["configs"].append({"name": "tiny", "source": "tests", "reduced": [],
                             "file": "benchmark/configs/tiny.json", "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            kind = "tiny_train" if any("train" in w for w in m["workloads"]) else "tiny_eval"
            m["workloads"].append(kind)
    write(dst / "BENCHMARK.json", bench)
    return dst


def write(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


def load(root: Path, cell: str):
    """``(configuration, mix)`` of a cell of ``root``."""
    from benchmark import harness

    w, cfg, mix, _ = harness.cell_parts(root, harness.load_benchmark(root), cell)
    return cfg, mix
