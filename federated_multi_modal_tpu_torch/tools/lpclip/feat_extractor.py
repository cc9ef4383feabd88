"""Linear-probe stage 1: CLIP feature extraction into .npz (port of
``tools/lpclip/feat_extractor.py``).

Extracts frozen CLIP image features for the train/val/test splits of a
catalog dataset and stores ``{split}.npz`` with ``feature_list`` /
``label_list`` under ``OUTPUT_DIR/<DatasetName>/``, as the JAX tool does;
``tools/lpclip/linear_probe.py`` reads them. The image tower runs under
``encode_image_auto(..., inference=True)`` with no gradient: at a ViT each
batch takes the fused inference block kernel (``fused_block_residual``,
once per block; the grouped kernel under ``FMM_TPU_FUSED_NBLK``), at a
ResNet no kernel of the port.

It runs on the card; ``FMM_TPU_PLATFORM=cpu`` asks for the CPU instead, and
without CUDA and unasked it raises.

Usage (from the repository root)::

    python -m federated_multi_modal_tpu_torch.tools.lpclip.feat_extractor \\
        --root <data_root> --dataset-config-file configs/datasets/caltech101.yaml \\
        --output-dir clip_feat --split train
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

import federated_multi_modal_tpu_torch.data.datasets  # noqa: F401 - registers the datasets
from federated_multi_modal_tpu_torch.config import get_cfg_default
from federated_multi_modal_tpu_torch.data.loader import DataLoader
from federated_multi_modal_tpu_torch.data.transforms import build_transform
from federated_multi_modal_tpu_torch.device import resolve_device
from federated_multi_modal_tpu_torch.engine.registry import build_dataset
from federated_multi_modal_tpu_torch.engine.tree import to_device
from federated_multi_modal_tpu_torch.models.clip_model import encode_image_auto
from federated_multi_modal_tpu_torch.models.params import load_clip_backbone
from federated_multi_modal_tpu_torch.ops.preprocess import crop_resize_flip_normalize
from federated_multi_modal_tpu_torch.train import platform_device
from federated_multi_modal_tpu_torch.utils import set_random_seed, setup_logger


def main(args):
    """Write ``{OUTPUT_DIR}/{DATASET.NAME}/{split}.npz``; returns the run's
    counts and host-clock times: ``images``, ``batches``, ``seconds`` (the
    loop over the loader, each batch's features back on the host) and
    ``loader_wait_seconds`` (the part of it spent waiting for the loader)."""
    device = resolve_device(platform_device())

    cfg = get_cfg_default()
    if args.dataset_config_file:
        cfg.merge_from_file(args.dataset_config_file)
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.root:
        cfg.DATASET.ROOT = args.root
    if args.output_dir:
        cfg.OUTPUT_DIR = args.output_dir
    if args.backbone:
        cfg.MODEL.BACKBONE.NAME = args.backbone
    cfg.DATASET.NUM_SHOTS = args.num_shots
    cfg.SEED = args.seed
    cfg.freeze()

    if cfg.SEED >= 0:
        set_random_seed(cfg.SEED)
    setup_logger(cfg.OUTPUT_DIR)

    dataset = build_dataset(cfg)
    split_data = {
        "train": dataset.train_x, "val": dataset.val, "test": dataset.test
    }[args.split]

    tfm = build_transform(cfg, is_train=False)
    loader = DataLoader(
        split_data,
        batch_size=cfg.DATALOADER.TRAIN_X.BATCH_SIZE,
        transform=tfm,
        is_train=False,
        sampler_type="SequentialSampler",
        drop_last=False,
    )

    arch, params = load_clip_backbone(cfg.MODEL)
    visual = to_device(params["visual"], device)

    def host(name):
        return torch.from_numpy(batch[name]).to(device)

    features, labels = [], []
    n_batches, wait = 0, 0.0
    start = time.perf_counter()
    batches = iter(loader)
    while True:
        t0 = time.perf_counter()
        batch = next(batches, None)
        wait += time.perf_counter() - t0
        if batch is None:
            break
        with torch.no_grad():
            if "canvas" in batch:
                images = crop_resize_flip_normalize(
                    host("canvas"), host("box"), host("flip"), out_size=cfg.INPUT.SIZE[0])
            else:
                images = host("img")
            # pure feature extraction: no grads ever -> fused inference tower
            feats = encode_image_auto(visual, arch, images, inference=True)
        features.extend(feats.float().cpu().numpy().tolist())
        n_batches += 1
        labels.extend(batch["label"].tolist())
    seconds = time.perf_counter() - start

    save_dir = os.path.join(cfg.OUTPUT_DIR, cfg.DATASET.NAME)
    os.makedirs(save_dir, exist_ok=True)
    np.savez(
        os.path.join(save_dir, args.split),
        feature_list=features,
        label_list=labels,
    )
    print(f"Saved {len(labels)} features to {save_dir}/{args.split}.npz")
    return {"images": len(labels), "batches": n_batches, "seconds": seconds,
            "loader_wait_seconds": wait}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", type=str, default="")
    parser.add_argument("--output-dir", type=str, default="clip_feat")
    parser.add_argument("--config-file", type=str, default="")
    parser.add_argument("--dataset-config-file", type=str, default="")
    parser.add_argument("--backbone", type=str, default="")
    parser.add_argument("--split", type=str, default="train",
                        choices=["train", "val", "test"])
    parser.add_argument("--num-shots", type=int, default=-1)
    parser.add_argument("--seed", type=int, default=-1)
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
