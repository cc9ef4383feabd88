"""Trainer base classes and the train step (port of
``federated_multi_modal_tpu/engine/trainer.py``).

``TrainerX`` reproduces the lifecycle of the Dassl trainers:
``__init__`` -> ``build_data_loader()`` -> ``build_model()``; ``train()``
epoch loop with ``before/after_epoch`` hooks and per-batch
``forward_backward``; ``test()`` through the registered evaluator;
``register_model`` + ``save_model``/``load_model`` checkpointing in the JAX
package's file format; the per-epoch LR step.

Each prompt trainer (``FunctionalTrainerMixin``) owns explicit state, as in
the JAX package:

* ``frozen``      — the non-trained parameter tree (CLIP weights under the
                    dtype policy + class-conditioned constants), on the
                    trainer's device, no leaf requiring a gradient;
* ``trainable``   — the fp32 tree being optimized;
* ``opt_state``   — the optimizer state, the learning rate in it;

and two functions: :func:`make_train_step_with_aux`'s step and the
(prompt-cached) eval. Image preprocessing runs on the device inside
``parse_batch_*``, so the uint8 canvas is the only host->device transfer.
Losses, gradient norms and the loss's aux stay on the device and are read
in one transfer at each print boundary (the deferred mode).
"""

from __future__ import annotations

import datetime
import os
import os.path as osp
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from federated_multi_modal_tpu_torch.device import resolve_device
from federated_multi_modal_tpu_torch.engine import evaluator as _evaluator  # noqa: F401 - registers Classification
from federated_multi_modal_tpu_torch.engine.checkpoint import (
    ForeignObject,
    drop_class_conditioned,
    find_resume_checkpoint,
    load_checkpoint,
    save_checkpoint,
    state_to_numpy,
    unflatten_into,
)
from federated_multi_modal_tpu_torch.engine.optim import (
    build_lr_schedule,
    get_learning_rate,
    global_norm,
    optimizer_from_cfg,
    set_learning_rate,
)
from federated_multi_modal_tpu_torch.engine.registry import build_evaluator
from federated_multi_modal_tpu_torch.engine.tree import (
    flatten,
    leaves,
    to_device,
    tree_map_multi,
    tree_map_with_path,
)
from federated_multi_modal_tpu_torch.models.params import COMPUTE_DTYPE
from federated_multi_modal_tpu_torch.ops.preprocess import crop_resize_flip_normalize
from federated_multi_modal_tpu_torch.parallel import mesh as _mesh
from federated_multi_modal_tpu_torch.parallel.mesh import mean_over_devices, replicate
from federated_multi_modal_tpu_torch.parallel.multihost import (
    is_main_process,
    process_count,
    sync_hosts,
)
from federated_multi_modal_tpu_torch.utils.profiling import span, trace


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------


def loss_grads_and_aux(loss_fn, trainable, frozen, batch):
    """``(loss, grads, aux)`` of ``loss_fn(trainable, frozen, batch) ->
    (loss, aux)``: the gradient of every leaf of ``trainable`` (zeros where
    the loss does not reach it), the loss and the aux's 0-d tensors
    detached. Spans: ``forward_backward`` around it all, ``backward``
    around the gradients."""
    with span("forward_backward"):
        tr = tree_map_with_path(lambda _, t: t.detach().requires_grad_(True), trainable)
        flat = flatten(tr)
        loss, aux = loss_fn(tr, frozen, batch)
        with span("backward"):
            got = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
        by_name = {name: torch.zeros_like(leaf) if g is None else g
                   for (name, leaf), g in zip(flat.items(), got)}
        grads = tree_map_with_path(lambda name, _: by_name[name], tr)
        return loss.detach(), grads, {k: v.detach() for k, v in aux.items()}


def make_train_step_with_aux(loss_fn, tx, grad_fn=None):
    """``train_step(trainable, frozen, opt_state, batch) -> (trainable,
    opt_state, loss, gnorm, aux)`` for ``loss_fn(trainable, frozen, batch)
    -> (loss, aux)`` and an optimizer ``tx`` (``engine/optim.py``).

    The gradient covers every leaf of ``trainable`` (a leaf the loss does
    not reach gets zeros); ``gnorm`` is its fp32 global norm before
    clipping; ``aux`` is the loss's dict of 0-d tensors, detached. When
    ``gnorm`` or the loss is not finite, the step leaves the params *and*
    the optimizer state as they were (the reference zeroes the gradients
    and skips the batch). Nothing is read back to the host. ``grad_fn``
    replaces :func:`loss_grads_and_aux` (the data-parallel steps of
    :meth:`FunctionalTrainerMixin._setup_data_parallel`). What follows the
    gradients (the norm, the clip, the optimizer, the gate) is span
    ``update``."""
    if grad_fn is None:
        def grad_fn(trainable, frozen, batch):
            return loss_grads_and_aux(loss_fn, trainable, frozen, batch)

    def train_step(trainable, frozen, opt_state, batch):
        loss, grads, aux = grad_fn(trainable, frozen, batch)
        with span("update"):
            gnorm = global_norm(grads)
            finite = torch.isfinite(gnorm) & torch.isfinite(loss)
            updates, new_state = tx.update(grads, opt_state, trainable)
            trainable = tree_map_multi(lambda p, u: torch.where(finite, p + u, p),
                                       trainable, updates)
            opt_state = tree_map_multi(lambda new, old: torch.where(finite, new, old),
                                       new_state, opt_state)
        return trainable, opt_state, loss, gnorm, aux

    return train_step


def make_train_step(loss_fn, tx):
    """:func:`make_train_step_with_aux`'s step without the aux:
    ``(trainable, opt_state, loss, gnorm)``."""
    step = make_train_step_with_aux(loss_fn, tx)

    def train_step(trainable, frozen, opt_state, batch):
        return step(trainable, frozen, opt_state, batch)[:4]

    return train_step


def _collective_device() -> torch.device:
    """Where a ``torch.distributed`` collective's tensors live: the current
    card under NCCL, the CPU under Gloo."""
    if torch.distributed.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_scalar(value: float) -> np.ndarray:
    """``value`` from every process, in process order (fp64)."""
    device = _collective_device()
    mine = torch.tensor([value], dtype=torch.float64, device=device)
    out = [torch.empty_like(mine) for _ in range(torch.distributed.get_world_size())]
    torch.distributed.all_gather(out, mine)
    return torch.cat(out).cpu().numpy()


def all_reduce_mean(tree):
    """The mean over processes of every leaf of ``tree`` (each on its own
    device, any float dtype): one ``all_reduce`` of the leaves flattened
    into one fp32 buffer, divided by the number of processes."""
    flat = flatten(tree)
    values = list(flat.values())
    device = values[0].device
    buf = torch.cat([v.detach().float().reshape(-1).to(device) for v in values])
    torch.distributed.all_reduce(buf)
    buf = buf / torch.distributed.get_world_size()
    out, i = {}, 0
    for name, v in flat.items():
        out[name] = buf[i:i + v.numel()].reshape(v.shape).to(v.dtype).to(v.device)
        i += v.numel()
    return tree_map_with_path(lambda name, _: out[name], tree)


def tree_finite(tree) -> bool:
    """The validity gate over a tree (reference ``check_weights_valid``,
    ``trainers/maple_fed.py:317-325``): every element of every non-None
    leaf finite (as on the leaf cast to fp32: the cast is exact), read back
    to the host in one transfer."""
    flags = [torch.isfinite(x).all() for x in leaves(tree)]
    if not flags:
        return True
    return bool(torch.stack(flags).all())


def resolve_attention_impl(cfg, device: torch.device) -> str:
    """``TPU.ATTENTION_IMPL``; ``"auto"`` is the kernel routes on CUDA and
    the plain formulation elsewhere (the JAX package's rule: its kernels on
    the accelerator, XLA on the CPU)."""
    impl = getattr(cfg.TPU, "ATTENTION_IMPL", "auto")
    if impl == "auto":
        impl = "pallas" if device.type == "cuda" else "xla"
    return impl


# --------------------------------------------------------------------------
# base trainer
# --------------------------------------------------------------------------


class TrainerBase:
    """Lifecycle + checkpoint registry (Dassl ``TrainerBase`` analog)."""

    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.check_cfg(cfg)

        # module globals of the port, set before any model runs (as the JAX
        # package sets its own before tracing)
        from federated_multi_modal_tpu_torch.models.clip_model import set_text_pack
        from federated_multi_modal_tpu_torch.ops.primitives import set_attention_impl

        set_attention_impl(resolve_attention_impl(cfg, self.device))
        set_text_pack(bool(getattr(cfg.TPU, "TEXT_PACK", True)))

        self._models: Dict[str, dict] = {}

        self.start_epoch = 0
        self.epoch = 0
        self.max_epoch = cfg.OPTIM.MAX_EPOCH
        self.output_dir = cfg.OUTPUT_DIR
        self.best_result = -np.inf
        # per epoch: wall seconds, seconds the host waited on the loader,
        # steps (no device synchronisation is added to measure them)
        self.epoch_stats = []

        self.dm = None
        self.train_loader_x = None
        self.val_loader = None
        self.test_loader = None

        self.build_data_loader()
        self.build_model()

        lab2cname = getattr(self.dm, "lab2cname", {}) if self.dm else {}
        self.evaluator = build_evaluator(cfg, lab2cname=lab2cname)

    # -- hooks ---------------------------------------------------------------
    def check_cfg(self, cfg):
        pass

    def build_data_loader(self):
        from federated_multi_modal_tpu_torch.data.manager import DataManager

        self.dm = DataManager(self.cfg)
        self.train_loader_x = self.dm.train_loader_x
        self.val_loader = self.dm.val_loader
        self.test_loader = self.dm.test_loader
        self.num_classes = self.dm.num_classes

    def build_model(self):
        raise NotImplementedError

    # -- model registry ---------------------------------------------------------
    def register_model(self, name: str, get_state: Callable[[], dict],
                       set_state: Callable[[dict], None]):
        """Register a named checkpointable unit.

        ``get_state()`` returns ``{"state_dict": flat np dict, "optimizer":
        any, "scheduler": any}``; ``set_state(flat_dict)`` loads weights
        non-strictly.
        """
        if name in self._models:
            raise KeyError(f"Model {name!r} already registered")
        self._models[name] = {"get": get_state, "set": set_state}

    def get_model_names(self, names=None):
        if names is not None:
            return [n for n in names if n in self._models]
        return list(self._models)

    # -- training loop ----------------------------------------------------------
    def train(self):
        self.before_train()
        self.time_start = time.time()
        for self.epoch in range(self.start_epoch, self.max_epoch):
            self.before_epoch()
            self.run_epoch()
            self.after_epoch()
        self.after_train()

    def before_train(self):
        if self.cfg.RESUME:
            self.start_epoch = self.resume_model_if_exist(self.cfg.RESUME)
        self.time_start = time.time()

    def before_epoch(self):
        pass

    def after_epoch(self):
        last_epoch = (self.epoch + 1) == self.max_epoch
        freq = self.cfg.TRAIN.CHECKPOINT_FREQ
        # best-val tracking (Dassl TrainerX after_epoch protocol), gated on
        # do_test like Dassl; test(split="val") falls back to the test split
        if (
            self.cfg.TEST.FINAL_MODEL == "best_val"
            and not self.cfg.TEST.NO_TEST
        ):
            result = self.test(split="val")["accuracy"]
            if result > self.best_result:
                self.best_result = result
                print(f"New best val accuracy: {result:.2f}%")
                self.save_model(
                    self.epoch, val_result=result, is_best=True
                )
        if (freq > 0 and (self.epoch + 1) % freq == 0) and not last_epoch:
            self.save_model(self.epoch)

    def after_train(self):
        # parse_test_res matches metrics printed AFTER this end signal
        print("Finished training")
        if not self.cfg.TEST.NO_TEST:
            if self.cfg.TEST.FINAL_MODEL == "best_val":
                print("Deploy the model with the best val performance")
                sync_hosts("best-val-checkpoint")  # process 0 wrote it
                self.load_model(self.output_dir)
            self.test()
        self.save_model(self.epoch)
        elapsed = round(time.time() - self.time_start)
        print(f"Elapsed: {datetime.timedelta(seconds=elapsed)}")

    def run_epoch(self, progress: bool = True):
        """One epoch; returns the mean loss. ``progress`` False (an
        aggregator's local epoch): no per-batch lines, and deferred
        summaries drained only every ``TRAIN.PRINT_FREQ`` steps and at the
        end. Under ``TRAIN.PROFILE_DIR`` the epoch is traced into it
        (``utils/profiling.py``)."""
        with trace(self.cfg.TRAIN.PROFILE_DIR):
            return self._run_epoch_inner(progress)

    def _run_epoch_inner(self, progress: bool):
        self.set_model_mode("train")
        losses = []
        self.num_batches = len(self.train_loader_x)
        freq = max(1, self.cfg.TRAIN.PRINT_FREQ)
        # deferred dispatch: no host<->device round trip per batch; drain
        # summaries in one transfer at each print boundary
        defer = hasattr(self, "drain_summaries")
        if defer:
            self._sync_steps = False
        t_epoch = end = time.time()
        wait = 0.0
        batches = iter(self.train_loader_x)
        try:
            self.batch_idx = -1
            while True:
                t_wait = time.time()
                batch = next(batches, None)
                wait += time.time() - t_wait
                if batch is None:
                    break
                self.batch_idx += 1
                loss_summary = self.forward_backward(batch)
                boundary = (
                    (self.batch_idx + 1) % freq == 0
                    or (progress and self.num_batches < freq)
                    or (self.batch_idx + 1) == self.num_batches
                )
                if defer and boundary:
                    drained = self.drain_summaries()
                    losses.extend(d["loss"] for d in drained)
                    loss_summary = drained[-1] if drained else None
                elif not defer:
                    losses.append(loss_summary.get("loss", 0.0))
                if progress and boundary and loss_summary is not None:
                    info = " ".join(
                        f"{k} {v:.4f}" for k, v in loss_summary.items()
                    )
                    print(
                        f"epoch [{self.epoch + 1}/{self.max_epoch}] "
                        f"batch [{self.batch_idx + 1}/{self.num_batches}] "
                        f"{info} lr {self.get_current_lr():.4e} "
                        f"time {time.time() - end:.3f}"
                    )
                end = time.time()
        finally:
            batches.close()  # ends the loader's prefetch thread
            if defer:
                self.end_deferred()
        self.epoch_stats.append({"epoch": self.epoch, "epoch_s": time.time() - t_epoch,
                                 "loader_wait_s": wait, "steps": self.batch_idx + 1,
                                 "mean_loss": float(np.mean(losses)) if losses else 0.0})
        return float(np.mean(losses)) if losses else 0.0

    def forward_backward(self, batch) -> dict:
        raise NotImplementedError

    def set_model_mode(self, mode="train"):
        self.training = mode == "train"

    def update_lr(self):
        raise NotImplementedError

    def get_current_lr(self) -> float:
        return 0.0

    # -- evaluation ----------------------------------------------------------
    def model_inference(self, images) -> torch.Tensor:
        raise NotImplementedError

    def parse_batch_images(self, batch):
        """Images onto the device; the canvas pipeline's crop, resize, flip
        and normalisation run there."""
        if "canvas" in batch:
            return crop_resize_flip_normalize(
                torch.from_numpy(batch["canvas"]).to(self.device),
                torch.from_numpy(batch["box"]).to(self.device),
                torch.from_numpy(batch["flip"]).to(self.device),
                out_size=self.cfg.INPUT.SIZE[0],
            )
        return torch.from_numpy(batch["img"]).to(self.device, COMPUTE_DTYPE)

    @torch.no_grad()
    def test(self, split: Optional[str] = None) -> dict:
        self.set_model_mode("eval")
        self.evaluator.reset()
        if split is None:
            split = self.cfg.TEST.SPLIT
        if split == "val" and self.val_loader is not None:
            loader = self.val_loader
        else:
            split = "test"
            loader = self.test_loader
        print(f"Evaluate on the *{split}* set")

        # one-batch lag: launch batch k+1 before reading batch k's logits,
        # so the host's work and the device's overlap. A short last batch
        # runs at its own size (the JAX package pads it to keep one
        # compiled program; the port has none to keep).
        pending = None
        for batch in loader:
            images = self.parse_batch_images(batch)
            logits = self.model_inference(images)
            if pending is not None:
                self.evaluator.process(pending[0].float().cpu().numpy(), pending[1])
            pending = (logits, batch["label"])
        if pending is not None:
            self.evaluator.process(pending[0].float().cpu().numpy(), pending[1])
        return self.evaluator.evaluate()

    # -- checkpointing ------------------------------------------------------------
    def save_model(self, epoch=None, directory="", is_best=False, val_result=None):
        if not is_main_process():  # one writer across processes
            return
        if not directory:
            directory = self.output_dir
        epoch = self.epoch if epoch is None else epoch
        for name in self.get_model_names():
            state = self._models[name]["get"]()
            optimizer = state.get("optimizer")
            if optimizer is None and getattr(self, "opt_state", None) is not None:
                # Dassl checkpoints carry the optimizer state (momentum) so
                # a resumed run continues exactly; numpy leaves only
                optimizer = state_to_numpy(self.opt_state)
            payload = {
                "epoch": epoch + 1,
                "state_dict": state["state_dict"],
                "optimizer": optimizer,
                "scheduler": state.get("scheduler"),
                "val_result": val_result,
                "cfg": self.cfg.dump(),
            }
            save_checkpoint(payload, osp.join(directory, name), is_best=is_best)

    def load_model(self, directory, epoch=None):
        if not directory:
            print("Note that load_model() is skipped as no pretrained model is given")
            return
        model_file = "model-best.pth.tar"
        if epoch is not None:
            model_file = f"model.pth.tar-{epoch}"
        for name in self.get_model_names():
            model_path = osp.join(directory, name, model_file)
            if not osp.exists(model_path):
                raise FileNotFoundError(f'Model not found at "{model_path}"')
            checkpoint = load_checkpoint(model_path)
            state_dict = drop_class_conditioned(checkpoint["state_dict"])
            loaded_epoch = checkpoint.get("epoch")
            print(
                f'Loading weights to {name} from "{model_path}" '
                f"(epoch = {loaded_epoch})"
            )
            self._models[name]["set"](state_dict)

    def resume_model_if_exist(self, directory) -> int:
        sync_hosts("resume-checkpoint")  # written by process 0
        start = 0
        for name in self.get_model_names():
            fpath = find_resume_checkpoint(osp.join(directory, name))
            if fpath is None:
                continue
            checkpoint = load_checkpoint(fpath)
            self._models[name]["set"](checkpoint["state_dict"])
            start = checkpoint.get("epoch", 0)
            restored_opt = False
            saved_opt = checkpoint.get("optimizer")
            if saved_opt is not None and getattr(self, "opt_state", None) is not None:
                restored_opt = self._restore_optimizer(saved_opt)
            print(f"Resumed {name} from {fpath} (epoch {start})")
            if not restored_opt and start > 0 and hasattr(self, "set_epoch_lr"):
                # momentum restarts at zero, but the LR must jump to the
                # resumed epoch's schedule value
                self.set_epoch_lr(start)
        return start

    def _restore_optimizer(self, saved) -> bool:
        """Load a saved optimizer state when it has the current one's names
        and shapes (a state the JAX package wrote, or one of another
        optimizer, does not: momentum restarts)."""
        current = flatten(self.opt_state)
        if isinstance(saved, ForeignObject) or not isinstance(saved, dict):
            flat_saved = None
        else:
            flat_saved = {k: np.asarray(v) for k, v in flatten(saved).items()}
        if flat_saved is None or set(flat_saved) != set(current) or any(
                flat_saved[k].shape != tuple(v.shape) for k, v in current.items()):
            print("Saved optimizer state does not match the current optimizer "
                  "(names/shapes differ); momentum restarts, LR set from the schedule")
            return False
        self.opt_state, _ = unflatten_into(self.opt_state, flat_saved, strict=True)
        return True


class TrainerX(TrainerBase):
    """Supervised single-source trainer (Dassl ``TrainerX`` analog)."""

    def parse_batch_train(self, batch):
        images = self.parse_batch_images(batch)
        labels = torch.from_numpy(batch["label"]).to(self.device)
        return images, labels


# --------------------------------------------------------------------------
# shared functional-trainer machinery for the prompt-learning methods
# --------------------------------------------------------------------------


class FunctionalTrainerMixin:
    """State + step plumbing shared by all prompt trainers.

    Subclasses must set:
      ``self.frozen``       frozen tree, on ``self.device``
      ``self.trainable``    fp32 trainable tree, on ``self.device``
      ``self.loss_fn(trainable, frozen, batch_dict) -> (loss, aux)``
      ``self.logits_fn(trainable, frozen, images) -> logits``
    and call ``self.setup_optimization()``.
    """

    # trainer-level grad-clip override: None = follow cfg.OPTIM.
    # GRAD_CLIP_NORM; MaPLe sets 1.0 (the reference hard-codes its clip)
    GRAD_CLIP_OVERRIDE: float | None = None

    def setup_optimization(self):
        cfg_optim = self.cfg.OPTIM
        if self.GRAD_CLIP_OVERRIDE is not None:
            cfg_optim = cfg_optim.clone()
            cfg_optim.defrost()
            cfg_optim.GRAD_CLIP_NORM = float(self.GRAD_CLIP_OVERRIDE)
        # the kernel routes read which weights train from requires_grad:
        # no frozen leaf may carry it (the step sets it on the trainable ones)
        self.frozen = tree_map_with_path(lambda _, t: t.detach(), self.frozen)
        self.sched_fn = build_lr_schedule(cfg_optim)
        self.tx = optimizer_from_cfg(cfg_optim, learning_rate=self.sched_fn(0))
        self.opt_state = self.tx.init(self.trainable)
        self.lr_history = [self.sched_fn(0)]
        # NaN bookkeeping mirroring the reference's fp16 failure machinery
        self.nan_count = 0
        self.total_batches = 0
        # deferred mode: the epoch loop turns _sync_steps off; summaries
        # stay on the device and drain in one transfer at print boundaries
        self._sync_steps = True
        self._pending_summaries = []
        self._setup_data_parallel(self.cfg)
        self._train_step = make_train_step_with_aux(self.loss_fn, self.tx,
                                                    self._dp_grad_fn())

        # optional eval fast path: eval_prepare_fn(trainable, frozen) ->
        # prepared (the image-free work, once per eval) and
        # eval_apply_fn(trainable, frozen, images, prepared) -> logits
        self._eval_cache = None
        self._eval_prepare = getattr(self, "eval_prepare_fn", None)
        self._eval_apply = getattr(self, "eval_apply_fn", None)

    # -- data parallelism ----------------------------------------------------
    def _setup_data_parallel(self, cfg):
        """``TPU.DATA_PARALLEL``, the reference's ``nn.DataParallel``
        (``trainers/maple.py:510-514``) over the devices a step can use.

        One process: with more than one visible device, the trainable and
        frozen trees are replicated on each (the frozen copies made once per
        source tensor), the batch is split along axis 0 where it divides
        and replicated otherwise, and the shards' gradients, losses and aux
        are averaged on the trainer's device before the clip and the
        optimizer (:meth:`_dp_grad_fn`). Several processes
        (``torch.distributed`` initialised with more than one): only with
        ``TPU.DATA_PARALLEL_MULTIHOST``, opt-in as in the JAX package
        because the federated trainers have their own cross-process rules;
        each process's batch is its shard of the global batch, split again
        over the process's local devices (``mesh.local_devices``), and the
        gradients, loss and aux are averaged over the local devices, then
        go through one ``all_reduce`` and are divided by the number of
        processes. Either way the device list starts with the trainer's
        device, where the shards' gradients meet."""
        self._dp_devices = None
        self._dp_multihost = False
        if not getattr(cfg.TPU, "DATA_PARALLEL", True):
            return
        device = self.device
        if process_count() > 1:
            if not getattr(cfg.TPU, "DATA_PARALLEL_MULTIHOST", False):
                return
            self._dp_multihost = True
            self._dp_verify_scalars = os.environ.get(
                "FMM_TPU_MULTIHOST_VERIFY_SCALARS", "0").lower() not in ("0", "", "false", "off")
            # the knob gates a collective in _dp_shard: a partial enable would
            # leave the processes that skip it waiting there; checked once here
            # (this gather runs on every process)
            flags = all_gather_scalar(float(self._dp_verify_scalars))
            if not np.all(flags == flags[0]):
                raise ValueError(
                    "FMM_TPU_MULTIHOST_VERIFY_SCALARS is set on some processes but not "
                    f"others (per-process values {flags.astype(int).tolist()}); it gates a "
                    "collective and must be identical on every process")
            devices = _mesh.local_devices(device)
        else:
            devices = _mesh.visible_devices(device)
        if len(devices) <= 1:
            return
        i = next((i for i, d in enumerate(devices)
                  if _mesh.same_device(d, torch.device(device))), None)
        if i is None:
            raise ValueError(f"the trainer's device {device} is not one of the visible "
                             f"devices {devices}")
        self._dp_devices = [devices[i]] + devices[:i] + devices[i + 1:]

    def _dp_shard(self, tree) -> list:
        """``[(device, shard of tree)]``, one entry a device, each shard on
        the trainer's device (``mesh.run_replicas`` moves it). Single-process
        DP splits each leaf whose axis 0 the devices divide and replicates
        the others (one entry on the trainer's device when no leaf
        divides). Multi-process DP splits every leaf with an axis 0 over
        this process's local devices, and raises where the local count does
        not divide it (this process's batch is its shard of the global
        batch, so a leaf that cannot be split would train on inconsistent
        data); 0-d leaves are replicated and, with
        ``FMM_TPU_MULTIHOST_VERIFY_SCALARS``, held equal across
        processes."""
        device = self.device
        devices = self._dp_devices or [device]
        n = len(devices)

        def divides(x):
            return x.ndim >= 1 and x.shape[0] > 0 and x.shape[0] % n == 0

        if self._dp_multihost:
            for name, x in flatten(tree).items():
                if x.ndim >= 1 and not divides(x):
                    raise ValueError(
                        f"multi-host DP requires every batch leaf's axis 0 ({x.shape[0]}) "
                        f"to be divisible by the local device count ({n}); pad the batch or "
                        "change DATALOADER.*.BATCH_SIZE")
                if x.ndim == 0 and self._dp_verify_scalars:
                    gathered = all_gather_scalar(float(x))
                    same = (gathered == gathered[0]) | (np.isnan(gathered)
                                                       & np.isnan(gathered[0]))
                    if not np.all(same):
                        raise ValueError(
                            f"0-d batch leaf {name} differs across processes (per-process "
                            f"values {gathered}); multi-host DP replicates scalars and "
                            "requires them identical everywhere")
        if n == 1 or not any(divides(x) for x in leaves(tree)):
            return [(device, to_device(tree, device))]
        return [(d, tree_map_with_path(
            lambda _, x, j=j: x.chunk(n)[j] if divides(x) else x, tree))
            for j, d in enumerate(devices)]

    def _dp_grad_fn(self):
        """The gradient function of the data-parallel step, or ``None``
        (the plain one) without data parallelism: the shards through
        ``mesh.run_replicas`` (each on a stream of its own), their mean on
        the trainer's device, and under multi-process DP the mean over
        processes of that."""
        if self._dp_devices is None and not self._dp_multihost:
            return None
        loss_fn = self.loss_fn

        def grad_fn(trainable, frozen, batch):
            def work(d, x):
                return loss_grads_and_aux(loss_fn, x[0], replicate(frozen, d), x[1])

            home = self.device
            shards = self._dp_shard(batch)
            outs = _mesh.run_replicas(work, [d for d, _ in shards],
                                      [(trainable, b) for _, b in shards], home)
            if len(outs) == 1:
                loss, grads, aux = outs[0]
            else:
                loss, grads, aux = (mean_over_devices([o[i] for o in outs], home)
                                    for i in range(3))
            if self._dp_multihost:
                loss, grads, aux = all_reduce_mean((loss, grads, aux))
            return loss, grads, aux

        return grad_fn

    def load_init_weights(self):
        """``cfg.MODEL.INIT_WEIGHTS``: load a checkpoint file into the
        trainable tree, non-strict, dropping class-conditioned buffers; a
        present key of the wrong shape raises."""
        path = self.cfg.MODEL.INIT_WEIGHTS
        if not path:
            return
        ckpt = load_checkpoint(path)
        flat = drop_class_conditioned(ckpt.get("state_dict", ckpt))
        self.trainable, used = unflatten_into(self.trainable, flat, strict_shapes=True)
        self._eval_cache = None
        print(f"Initialized {len(used)} tensors from {path}")

    # -- training -----------------------------------------------------------
    def train_step(self, batch_dict):
        """One optimizer step. Returns the float summary dict, or ``None``
        in deferred mode (``_sync_steps`` off) — drain with
        :meth:`drain_summaries`."""
        self.total_batches += 1
        self._eval_cache = None  # weights change -> cached eval state stale
        self.trainable, self.opt_state, loss, gnorm, aux = self._train_step(
            self.trainable, self.frozen, self.opt_state, batch_dict)
        if not self._sync_steps:
            self._pending_summaries.append((loss, gnorm, aux))
            return None
        return self._read_summaries([(loss, gnorm, aux)])[0]

    def _read_summaries(self, pending) -> list:
        """The summaries of ``pending`` steps, read in one transfer."""
        keys = [sorted(aux) for _, _, aux in pending]
        rows = [torch.stack([loss.float(), gnorm.float(), *(aux[k].float() for k in ks)])
                for (loss, gnorm, aux), ks in zip(pending, keys)]
        values = torch.cat(rows).cpu().numpy()
        out, i = [], 0
        for ks in keys:
            n = 2 + len(ks)
            row = values[i:i + n]
            i += n
            out.append(self._finalize_summary(row[0], row[1], dict(zip(ks, row[2:]))))
        return out

    def drain_summaries(self) -> list:
        """Materialize all pending deferred step summaries (one transfer)."""
        if not self._pending_summaries:
            return []
        pending, self._pending_summaries = self._pending_summaries, []
        return self._read_summaries(pending)

    def end_deferred(self):
        """Leave deferred mode; discard summaries an aborted epoch left
        behind so they cannot leak into the next drain."""
        self._sync_steps = True
        self._pending_summaries = []

    def _finalize_summary(self, loss, gnorm, aux) -> dict:
        loss = float(loss)
        if not np.isfinite(loss):
            # skip-batch semantics: params/momentum were left untouched by
            # the non-finite gate inside the step; count it here
            self.nan_count += 1
            print(
                f"NaN rate: {self.nan_count / max(1, self.total_batches):.2%}"
            )
        out = {"loss": loss, "grad_norm": float(gnorm)}
        out.update({k: float(v) for k, v in aux.items()})
        return out

    @torch.no_grad()
    def model_inference(self, images):
        """The logits of ``images``. Under single-process DP the images are
        split over the devices as a train batch is (each share a replica of
        ``mesh.run_replicas``), and the logits gathered on the trainer's
        device; under multi-process DP the eval is process-local and on the
        trainer's device (each process evaluates its own loader's batches;
        the trained state is the same in every process), as the JAX
        package's is."""
        if self._eval_prepare is not None and self._eval_cache is None:
            self._eval_cache = self._eval_prepare(self.trainable, self.frozen)
        if getattr(self, "_dp_devices", None) is None or self._dp_multihost:
            return self._logits(self.trainable, self.frozen, images, self._eval_cache)

        def work(d, x):
            return self._logits(x[0], replicate(self.frozen, d), x[1], x[2])

        shards = self._dp_shard(images)
        logits = _mesh.run_replicas(work, [d for d, _ in shards],
                                    [(self.trainable, imgs, self._eval_cache)
                                     for _, imgs in shards], self.device)
        return torch.cat(logits)

    def _logits(self, trainable, frozen, images, prepared):
        if self._eval_prepare is not None:
            return self._eval_apply(trainable, frozen, images, prepared)
        return self.logits_fn(trainable, frozen, images)

    # -- LR schedule ----------------------------------------------------------
    def update_lr(self):
        """Per-epoch scheduler step (Dassl steps schedulers per epoch)."""
        new_lr = self.sched_fn(self.epoch + 1)
        self.opt_state = set_learning_rate(self.opt_state, new_lr)
        if not self.lr_history or self.lr_history[-1] != new_lr:
            self.lr_history.append(new_lr)

    def set_epoch_lr(self, epoch: int):
        """Jump the schedule to a given global epoch."""
        self.opt_state = set_learning_rate(self.opt_state, self.sched_fn(epoch))

    def get_current_lr(self) -> float:
        return get_learning_rate(self.opt_state)

    def invalidate_eval_cache(self):
        self._eval_cache = None

    def reset_optimizer_state(self):
        """Drop momentum, keep the LR."""
        self._eval_cache = None
        lr = self.get_current_lr()
        self.opt_state = set_learning_rate(self.tx.init(self.trainable), lr)


def count_params(tree) -> int:
    return sum(t.numel() for t in leaves(tree))
