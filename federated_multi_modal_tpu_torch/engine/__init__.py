from federated_multi_modal_tpu_torch.engine.registry import (
    DATASET_REGISTRY,
    EVALUATOR_REGISTRY,
    TRAINER_REGISTRY,
    build_dataset,
    build_evaluator,
    build_trainer,
)

__all__ = [
    "DATASET_REGISTRY",
    "EVALUATOR_REGISTRY",
    "TRAINER_REGISTRY",
    "build_dataset",
    "build_evaluator",
    "build_trainer",
]
