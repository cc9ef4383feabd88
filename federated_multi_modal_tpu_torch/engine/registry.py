"""Name-based registries for trainers, datasets and evaluators (port of
``federated_multi_modal_tpu/engine/registry.py``; the port's own registries,
holding the port's classes).

Equivalent of Dassl's ``TRAINER_REGISTRY`` / ``DATASET_REGISTRY`` +
``build_trainer`` used throughout the reference (``train.py:6,177``,
``trainers/maple.py:10``, ``datasets/oxford_pets.py:11``).
"""

from typing import Callable, Dict


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._obj_map: Dict[str, Callable] = {}

    def register(self, obj=None, *, force: bool = False):
        if obj is None:
            def deco(fn_or_class):
                self._do_register(fn_or_class.__name__, fn_or_class, force)
                return fn_or_class

            return deco
        self._do_register(obj.__name__, obj, force)
        return obj

    def _do_register(self, name: str, obj: Callable, force: bool) -> None:
        if name in self._obj_map and not force:
            raise KeyError(
                f"An object named '{name}' was already registered in "
                f"'{self._name}' registry"
            )
        self._obj_map[name] = obj

    def get(self, name: str) -> Callable:
        if name not in self._obj_map:
            raise KeyError(
                f"'{name}' not found in '{self._name}' registry. "
                f"Available: {sorted(self._obj_map)}"
            )
        return self._obj_map[name]

    def registered_names(self):
        return sorted(self._obj_map)


TRAINER_REGISTRY = Registry("TRAINER")
DATASET_REGISTRY = Registry("DATASET")
EVALUATOR_REGISTRY = Registry("EVALUATOR")


def build_trainer(cfg, device=None):
    """The registered trainer ``cfg.TRAINER.NAME`` on ``device`` (``None``
    means ``"cuda"``, and raises without CUDA)."""
    from federated_multi_modal_tpu_torch.device import resolve_device

    device = resolve_device(device)
    name = cfg.TRAINER.NAME
    trainer_cls = TRAINER_REGISTRY.get(name)
    if cfg.VERBOSE:
        print(f"Loading trainer: {name}")
    return trainer_cls(cfg, device=device)


def build_dataset(cfg):
    name = cfg.DATASET.NAME
    dataset_cls = DATASET_REGISTRY.get(name)
    if cfg.VERBOSE:
        print(f"Loading dataset: {name}")
    return dataset_cls(cfg)


def build_evaluator(cfg, **kwargs):
    name = cfg.TEST.EVALUATOR
    return EVALUATOR_REGISTRY.get(name)(cfg, **kwargs)
