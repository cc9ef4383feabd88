"""The port's training command line (port of the repository's ``train.py``).

Same surface: ``python -m federated_multi_modal_tpu_torch.train --trainer
MaPLe --config-file configs/trainers/... --dataset-config-file
configs/datasets/... [--seed N] [--eval-only --model-dir D --load-epoch E]
[opts ...]``, with the same merge order: dataset yaml -> trainer yaml -> CLI
flags -> freeform opts; the same ``log.txt`` under ``--output-dir``, the
same checkpoints and the same printed lines.

It runs on the card; ``FMM_TPU_PLATFORM=cpu`` (the variable the JAX
package's ``train.py`` reads) asks for the CPU instead. A multi-process run
(one process per card, ``TPU.DATA_PARALLEL_MULTIHOST True``) is started by
``torchrun --nproc-per-node N -m federated_multi_modal_tpu_torch.train ...``
or by setting ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and
``JAX_PROCESS_ID`` in each process (``parallel/multihost.py``); process 0
alone writes ``log.txt`` and the checkpoints.
"""

from __future__ import annotations

import argparse
import os

from federated_multi_modal_tpu_torch.config import get_cfg_default
from federated_multi_modal_tpu_torch.engine import build_trainer
from federated_multi_modal_tpu_torch.parallel import (
    initialize_multihost,
    is_main_process,
    process_count,
)
from federated_multi_modal_tpu_torch.utils import (
    collect_env_info,
    set_random_seed,
    setup_logger,
)

# populate the registries
import federated_multi_modal_tpu_torch.data.datasets  # noqa: F401,E402
import federated_multi_modal_tpu_torch.trainers  # noqa: F401,E402


def print_args(args, cfg):
    print("***************")
    print("** Arguments **")
    print("***************")
    for key in sorted(args.__dict__):
        print(f"{key}: {args.__dict__[key]}")
    print("************")
    print("** Config **")
    print("************")
    print(cfg)


def reset_cfg(cfg, args):
    if args.root:
        cfg.DATASET.ROOT = args.root
    if args.output_dir:
        cfg.OUTPUT_DIR = args.output_dir
    if args.resume:
        cfg.RESUME = args.resume
    if args.seed:
        cfg.SEED = args.seed
    if args.source_domains:
        cfg.DATASET.SOURCE_DOMAINS = args.source_domains
    if args.target_domains:
        cfg.DATASET.TARGET_DOMAINS = args.target_domains
    if args.transforms:
        cfg.INPUT.TRANSFORMS = args.transforms
    if args.trainer:
        cfg.TRAINER.NAME = args.trainer
    if args.backbone:
        cfg.MODEL.BACKBONE.NAME = args.backbone
    if args.head:
        cfg.MODEL.HEAD.NAME = args.head


def setup_cfg(args):
    cfg = get_cfg_default()
    if args.dataset_config_file:
        cfg.merge_from_file(args.dataset_config_file)
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    reset_cfg(cfg, args)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    return cfg


def platform_device():
    """``FMM_TPU_PLATFORM``: ``cpu`` asks for the CPU; unset means the card
    (which raises where CUDA is not available)."""
    platform = os.environ.get("FMM_TPU_PLATFORM", "")
    if platform and platform not in ("cpu", "cuda", "gpu"):
        raise ValueError(f"FMM_TPU_PLATFORM={platform!r}: cpu or cuda")
    return "cpu" if platform == "cpu" else None


def main(args):
    """Build the trainer and train, or evaluate a checkpoint; returns the
    trainer."""
    # a multi-process run's process group before anything else; a no-op
    # for one process
    multihost = initialize_multihost(backend="gloo" if platform_device() == "cpu" else None)
    cfg = setup_cfg(args)
    # the log.txt tee first, so the seed and environment land in the file
    # tools/parse_test_res.py reads; one writer across processes
    if is_main_process():
        setup_logger(cfg.OUTPUT_DIR)
    if multihost:
        print(f"Multi-host run: {process_count()} processes")
    if cfg.SEED >= 0:
        print(f"Setting fixed seed: {cfg.SEED}")
        set_random_seed(cfg.SEED)

    print_args(args, cfg)
    print("Collecting env info ...")
    print(f"** System info **\n{collect_env_info()}\n")

    trainer = build_trainer(cfg, device=platform_device())

    if args.eval_only:
        trainer.load_model(args.model_dir, epoch=args.load_epoch)
        trainer.test()
        return trainer

    if not args.no_train:
        trainer.train()
    return trainer


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", type=str, default="", help="path to dataset")
    parser.add_argument("--output-dir", type=str, default="", help="output directory")
    parser.add_argument(
        "--resume", type=str, default="",
        help="checkpoint directory (from which the training resumes)",
    )
    parser.add_argument(
        "--seed", type=int, default=-1,
        help="only positive value enables a fixed seed",
    )
    parser.add_argument(
        "--source-domains", type=str, nargs="+", help="source domains for DA/DG"
    )
    parser.add_argument(
        "--target-domains", type=str, nargs="+", help="target domains for DA/DG"
    )
    parser.add_argument(
        "--transforms", type=str, nargs="+", help="data augmentation methods"
    )
    parser.add_argument("--config-file", type=str, default="", help="path to config file")
    parser.add_argument(
        "--dataset-config-file", type=str, default="",
        help="path to config file for dataset setup",
    )
    parser.add_argument("--trainer", type=str, default="", help="name of trainer")
    parser.add_argument("--backbone", type=str, default="", help="name of CNN backbone")
    parser.add_argument("--head", type=str, default="", help="name of head")
    parser.add_argument("--eval-only", action="store_true", help="evaluation only")
    parser.add_argument(
        "--model-dir", type=str, default="",
        help="load model from this directory for eval-only mode",
    )
    parser.add_argument(
        "--load-epoch", type=int, help="load model weights at this epoch for evaluation"
    )
    parser.add_argument(
        "--no-train", action="store_true", help="do not call trainer.train()"
    )
    parser.add_argument(
        "opts", default=None, nargs=argparse.REMAINDER,
        help="modify config options using the command-line",
    )
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
