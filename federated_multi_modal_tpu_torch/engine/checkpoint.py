"""Checkpoint I/O and parameter-tree <-> flat-name conversion (port of
``federated_multi_modal_tpu/engine/checkpoint.py``; the same files, so each
package reads the other's).

Keeps the reference's on-disk contract so tooling and habits transfer
(Dassl checkpoints, ``trainers/maple_fed.py:376-384``):

* files named ``model.pth.tar-{epoch}`` / ``model-best.pth.tar`` under
  ``<dir>/<registered model name>/``
* payload dict ``{epoch, state_dict, optimizer, scheduler, val_result,
  cfg}`` where ``state_dict`` maps dotted names to numpy arrays
* load-time class-set transfer: ``prompt_learner.token_prefix`` /
  ``token_suffix`` are dropped and loading is non-strict so checkpoints
  move across class sets (``trainers/maple.py:709-712``)

Serialization is pickle of numpy arrays (portable, no torch dependency):
bf16 tensors are written as fp32, and the optimizer state as a nested
dict of numpy arrays.
"""

from __future__ import annotations

import os.path as osp
import pickle
from typing import Dict

import numpy as np
import torch

from federated_multi_modal_tpu_torch.engine.tree import flatten, tree_map_with_path
from federated_multi_modal_tpu_torch.utils.io import mkdir_if_missing


# -- parameter tree <-> flat dotted-name dict -----------------------------------


def to_numpy(t) -> np.ndarray:
    """A host numpy copy of a tensor; bf16, which numpy lacks, as fp32
    (exactly)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def from_numpy(a, like: torch.Tensor) -> torch.Tensor:
    """``a`` (numpy, any float dtype the JAX package writes, bf16 included)
    as a tensor of ``like``'s dtype on ``like``'s device."""
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, copy=True)).to(device=like.device, dtype=like.dtype)


def flatten_params(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """``{dotted name: numpy array}`` for every leaf of a parameter tree of
    the port: the JAX package's names (``clip.visual.blocks.11.ln_1.scale``)."""
    flat = {}
    for name, leaf in flatten(tree).items():
        if prefix:
            name = f"{prefix}.{name}" if name else prefix
        flat[name] = to_numpy(leaf)
    return flat


def unflatten_into(tree, flat: Dict[str, np.ndarray], prefix: str = "",
                   strict: bool = False, strict_shapes: bool = False):
    """Write values from ``flat`` into a copy of ``tree`` by dotted name,
    each in its leaf's dtype and on its device.

    Names absent from ``flat`` keep their current value (strict=False
    semantics); unknown names are ignored (they were dropped buffers).
    ``strict_shapes`` reproduces torch's ``load_state_dict(strict=False)``
    contract: missing/unexpected keys are tolerated but a PRESENT key with
    the wrong shape raises. Returns ``(new tree, names used)``.
    """
    used = set()

    def replace(name, leaf):
        if prefix:
            name = f"{prefix}.{name}" if name else prefix
        if name in flat:
            arr = np.asarray(flat[name])
            if arr.shape != tuple(leaf.shape):
                if strict or strict_shapes:
                    raise ValueError(
                        f"Shape mismatch for {name}: checkpoint {arr.shape} "
                        f"vs model {tuple(leaf.shape)}"
                    )
                print(
                    f"Warning: skipping {name} (checkpoint shape "
                    f"{arr.shape} vs model {tuple(leaf.shape)})"
                )
                return leaf
            used.add(name)
            return from_numpy(arr, leaf)
        if strict:
            raise KeyError(f"Missing key in checkpoint: {name}")
        return leaf

    new_tree = tree_map_with_path(replace, tree)
    return new_tree, used


def state_to_numpy(tree):
    """A nested dict/list of tensors (an optimizer state) as the same
    structure of numpy arrays, so that a checkpoint holds no torch object
    and the JAX package can unpickle it."""
    return tree_map_with_path(lambda _, t: to_numpy(t), tree)


# -- file I/O -----------------------------------------------------------------


def save_checkpoint(state: dict, save_dir: str, is_best: bool = False,
                    model_name: str = "") -> str:
    mkdir_if_missing(save_dir)
    epoch = state.get("epoch", 0)
    if not model_name:
        model_name = f"model.pth.tar-{epoch}"
    fpath = osp.join(save_dir, model_name)
    with open(fpath, "wb") as f:
        pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
    # record the latest checkpoint name (Dassl writes a "checkpoint" file)
    with open(osp.join(save_dir, "checkpoint"), "w") as f:
        f.write(osp.basename(fpath))
    if is_best:
        best = osp.join(save_dir, "model-best.pth.tar")
        with open(best, "wb") as f:
            pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
    print(f"Checkpoint saved to {fpath}")
    return fpath


# the JAX package is this package's name without its suffix
_FOREIGN = ("jax", "jaxlib", "optax", "chex", "flax", __name__.split(".")[0].removesuffix("_torch"))


class ForeignObject:
    """Stands in for an object of the JAX stack in a checkpoint the JAX
    package wrote (its optax optimizer state): the port imports none of
    those modules, so the object keeps only its constructor arguments and
    pickled state."""

    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        obj.args, obj.state = args, None
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state


class _CheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in _FOREIGN:
            return ForeignObject
        return super().find_class(module, name)


def load_checkpoint(fpath: str) -> dict:
    """Unpickle a checkpoint written by either package; objects of the JAX
    stack in it come back as :class:`ForeignObject`."""
    if not osp.exists(fpath):
        raise FileNotFoundError(f'Checkpoint not found at "{fpath}"')
    with open(fpath, "rb") as f:
        return _CheckpointUnpickler(f).load()


def find_resume_checkpoint(directory: str):
    """Return the newest checkpoint path recorded in ``<dir>/checkpoint``
    (Dassl ``resume_from_checkpoint`` convention), else None."""
    marker = osp.join(directory, "checkpoint")
    if not osp.exists(marker):
        return None
    with open(marker) as f:
        name = f.read().strip()
    fpath = osp.join(directory, name)
    return fpath if osp.exists(fpath) else None


def drop_class_conditioned(state_dict: Dict[str, np.ndarray]):
    """Remove prompt prefix/suffix buffers so checkpoints transfer across
    class sets (``trainers/maple.py:709-712``, ``trainers/coop.py:319-324``)."""
    out = dict(state_dict)
    for key in list(out):
        leaf = key.rsplit(".", 1)[-1]
        if leaf in ("token_prefix", "token_suffix"):
            del out[key]
    return out
