"""MaPLeFederated, the federated aggregator (port of
``federated_multi_modal_tpu/trainers/maple_fed.py``, its sequential round
loop).

A round (reference ``trainers/maple_fed.py:228-303``): broadcast the global
weights (validity-gated) -> each client trains ``FED.LOCAL_EPOCHS`` at the
global epochs' schedule -> a client whose training raises ``RuntimeError``
is counted failed and left out -> a client whose weights are not finite is
reset to the global weights and left out -> FedAvg in fp32 with the
non-finite scrub -> a test on client 0 -> ``nan_stats`` -> the round
checkpoint. After the last round: the final test and the aggregator
checkpoint under ``MultiModalPromptLearner_Aggregator/``, in the JAX
package's file format, so that each package reads and resumes from the
other's.

As in the JAX package, the clients share one frozen CLIP tower on the
device (its leaves are the same tensors in every client) and FedAvg averages
only the trainable trees, which equals the reference's full-state average
since the frozen leaves are equal across clients; master weights are fp32.

With ``FED.PARALLEL_CLIENTS``, where the visible devices tile the clients
(:meth:`MaPLeFederated.parallel_would_run`; one card at ``FED.NUM_CLIENTS``
1), the clients run in lockstep on a client mesh (``parallel/mesh.py``,
``parallel/fedavg.py::build_parallel_fed_step``) and FedAvg is one mean
over the stacked client axis; elsewhere the sequential rounds run, with the
JAX package's line. ``TRAIN.CHECKPOINT_BACKEND orbax`` behaves as in the
JAX package where orbax is not importable (:meth:`MaPLeFederated._resume_round`).
"""

from __future__ import annotations

import glob
import os
import os.path as osp
from collections import defaultdict

import numpy as np
import torch

from federated_multi_modal_tpu_torch.data.datasets.ucmerced import UCMERCED_RENAME_MAP
from federated_multi_modal_tpu_torch.data.datum import Datum
from federated_multi_modal_tpu_torch.data.manager import ClientDataManager
from federated_multi_modal_tpu_torch.engine.checkpoint import (
    drop_class_conditioned,
    flatten_params,
    load_checkpoint,
    save_checkpoint,
    unflatten_into,
)
from federated_multi_modal_tpu_torch.engine.registry import TRAINER_REGISTRY, build_dataset
from federated_multi_modal_tpu_torch.engine.trainer import TrainerX, tree_finite
from federated_multi_modal_tpu_torch.engine.tree import tree_map_with_path
from federated_multi_modal_tpu_torch.models.params import load_clip_backbone
from federated_multi_modal_tpu_torch.parallel import (
    build_parallel_fed_step,
    fedavg_over_clients,
    stack_client_trees,
    unstack_client_trees,
)
from federated_multi_modal_tpu_torch.parallel import mesh as _mesh
from federated_multi_modal_tpu_torch.parallel.multihost import process_count
from federated_multi_modal_tpu_torch.trainers.maple import (
    MaPLe,
    dataset_provides_captions,
    maple_clip_params,
)

AGGREGATOR_DIR = "MultiModalPromptLearner_Aggregator"


def safe_average_trees(trees):
    """FedAvg with the non-finite scrub (``safe_average_weights``,
    ``trainers/maple_fed.py:309-315``): stack, scrub and average in fp32
    over the clients (``parallel/fedavg.py``)."""
    return unstack_client_trees(fedavg_over_clients(stack_client_trees(list(trees))), 1)[0]


def copy_tree(tree):
    return tree_map_with_path(lambda _, x: x.detach().clone(), tree)


@TRAINER_REGISTRY.register()
class MaPLeFederated(TrainerX):

    def __init__(self, cfg, device=None):
        self.lab2cname = {}
        self.num_clients = cfg.FED.NUM_CLIENTS
        self.num_rounds = cfg.FED.NUM_ROUNDS
        self.local_epochs = cfg.FED.LOCAL_EPOCHS
        self.clients = []
        self.global_weights = None
        self.nan_stats = {
            "total_updates": 0,
            "failed_clients": [],
            "skipped_rounds": 0,
        }
        super().__init__(cfg, device=device)

    def parallel_would_run(self, n_dev: int) -> bool:
        """Whether the parallel round loop runs over ``n_dev`` devices
        (``trainers/maple_fed.py:251-260`` of the JAX package): only where
        they tile the clients."""
        return n_dev >= self.num_clients and n_dev % max(1, self.num_clients) == 0

    # ------------------------------------------------------------------
    # A) unified data loading (reference :48-159)
    # ------------------------------------------------------------------
    def build_data_loader(self):
        cfg = self.cfg
        client_names = list(cfg.FED.DATASETS)
        extra_names = list(cfg.FED.CLASSNAME_ONLY_DATASETS)

        datasets = {}
        for name in client_names + extra_names:
            sub_cfg = cfg.clone()
            sub_cfg.defrost()
            sub_cfg.DATASET.NAME = name
            # only the dataset object is read here (the ClientDataManagers
            # build their own loaders)
            datasets[name] = build_dataset(sub_cfg)

        # UCMerced's vocabulary renamed into PatternNet's (reference
        # :84-96); each local label -> classname map over every split, so a
        # class present only in val or test still remaps
        def renamed_lab2cname(dataset, name):
            mapping = dict(dataset.lab2cname)
            for split in (dataset.val, dataset.test):
                for item in split or []:
                    mapping.setdefault(item.label, item.classname)
            if name == "Ucmerced":
                for k, cname in mapping.items():
                    mapping[k] = UCMERCED_RENAME_MAP.get(cname, cname)
            return mapping

        lab_maps = {name: renamed_lab2cname(ds, name) for name, ds in datasets.items()}

        # the global class list is the sorted union (reference :98-104)
        global_set = set()
        for mapping in lab_maps.values():
            global_set.update(mapping.values())
        global_list = sorted(global_set)
        print(f"[INFO] Unified #classes = {len(global_list)}")
        name2gid = {c: i for i, c in enumerate(global_list)}
        self.lab2cname = {i: c for i, c in enumerate(global_list)}

        def remap(data_list, local_map):
            # rebuilt without the domain field, as the reference does
            # (:117-123): federated clients are single-domain
            out = []
            for item in data_list:
                cname = local_map[item.label]
                out.append(Datum(impath=item.impath, label=name2gid[cname],
                                 classname=cname, caption=item.caption))
            return out

        if self.num_clients > len(client_names):
            raise ValueError(
                f"FED.NUM_CLIENTS={self.num_clients} but only "
                f"{len(client_names)} client dataset(s) in FED.DATASETS "
                f"{tuple(client_names)}"
            )
        self.client_data_managers = []
        for name in client_names[: self.num_clients]:
            ds = datasets[name]
            local_map = lab_maps[name]
            self.client_data_managers.append(
                ClientDataManager(
                    train_x=remap(ds.train_x, local_map),
                    val=remap(ds.val, local_map),
                    test=remap(ds.test, local_map),
                    cfg=cfg,
                )
            )

        cfg.defrost()
        cfg.MODEL.NUM_CLASSES = len(global_list)
        cfg.freeze()

        # the aggregator itself has no loaders (reference :154-158)
        self.train_loader_x = None
        self.val_loader = None
        self.test_loader = None
        self.dm = None
        self.num_classes = len(global_list)

    # ------------------------------------------------------------------
    # B) client construction (reference :164-176)
    # ------------------------------------------------------------------
    def build_model(self):
        cfg = self.cfg
        global_classnames = list(self.lab2cname.values())

        print(f"Loading CLIP (backbone: {cfg.MODEL.BACKBONE.NAME})")
        arch, clip_params = load_clip_backbone(cfg.MODEL)
        # MaPLe's form of the tower, on the device once for every client
        shared_clip = (arch, maple_clip_params(cfg.TRAINER.MAPLE.PREC, clip_params, self.device))
        del clip_params

        # one caption decision for all clients: FedAvg maps over the
        # clients' trainable trees, so the caption parameters exist either
        # in every client or in none
        caption_avail = [dataset_provides_captions(dm) for dm in self.client_data_managers]
        use_captions = all(caption_avail)
        if cfg.TRAINER.MAPLE.USE_CAPTIONS and not use_captions and any(caption_avail):
            print(
                f"[FED] caption availability differs across clients "
                f"{caption_avail}; disabling the caption branch everywhere "
                "(trainable structures must match for aggregation)"
            )

        self.clients = []
        for i, dm in enumerate(self.client_data_managers):
            self.clients.append(MaPLe(
                cfg, client_id=i, classnames=global_classnames, dm=dm,
                shared_clip=shared_clip, use_captions_override=use_captions,
                device=self.device))

        self.global_weights = copy_tree(self.clients[0].trainable)

    # ------------------------------------------------------------------
    # C) federated round loop (reference :228-303)
    # ------------------------------------------------------------------
    def train(self):
        # both round loops broadcast, average and checkpoint trees that live
        # in this process: under several processes each would train its own
        # aggregator and write the same files
        if process_count() > 1:
            raise RuntimeError(
                "MaPLeFederated.train() is single-process by design (like the "
                "reference aggregator): the round loops broadcast, average and "
                "checkpoint trees that live in this process. Run federated training "
                "as ONE process; several devices are used in-process through the "
                "client mesh (FED.PARALLEL_CLIENTS). Multi-process data parallelism "
                "exists only for the single-site trainers (TPU.DATA_PARALLEL_MULTIHOST, "
                "engine/trainer.py).")
        if self.cfg.FED.PARALLEL_CLIENTS:
            n_dev = len(_mesh.visible_devices(self.device))
            if self.parallel_would_run(n_dev):
                return self._train_parallel()
            print(
                f"[FED] PARALLEL_CLIENTS requested but {n_dev} device(s) "
                f"don't tile {self.num_clients} clients; falling back to "
                "sequential rounds."
            )
        return self._train_sequential()

    def _resume_round(self) -> int:
        """Resume from the newest round checkpoint under ``RESUME``
        (written with ``FED.CHECKPOINT_EVERY_ROUND``). Under
        ``TRAIN.CHECKPOINT_BACKEND orbax``, ``round-*.orbax`` directories
        there raise (orbax is not available to the port) rather than
        restart from round 0; without them the pickle rounds are read."""
        if not self.cfg.RESUME:
            return 0
        if self.cfg.TRAIN.CHECKPOINT_BACKEND == "orbax":
            # orbax-checkpoint is a JAX library and its tensorstore format
            # needs JAX to read; the port imports neither, so it takes the
            # JAX package's path for an orbax that is not importable: round
            # checkpoints are written in the pickle format (_save_round) and
            # orbax rounds found here are refused, never skipped.
            found = glob.glob(osp.join(self.cfg.RESUME, AGGREGATOR_DIR, "round-*.orbax"))
            rounds = [p for p in found
                      if osp.basename(p)[len("round-"):-len(".orbax")].isdigit()]
            if rounds:
                raise RuntimeError(
                    f"found {len(rounds)} orbax round checkpoint(s) under "
                    f"{self.cfg.RESUME} but orbax-checkpoint is not importable — "
                    "refusing to silently restart from round 0")
        rounds = []
        for path in glob.glob(osp.join(self.cfg.RESUME, AGGREGATOR_DIR, "model.pth.tar-round*")):
            try:
                rounds.append((int(path.rsplit("round", 1)[1]), path))
            except ValueError:
                continue
        if not rounds:
            return 0
        rnd, path = max(rounds)
        ckpt = load_checkpoint(path)
        flat = drop_class_conditioned(ckpt["state_dict"])
        self.global_weights, _ = unflatten_into(self.global_weights, flat)
        print(f"[FED] resumed round {rnd} from {path}")
        return rnd

    def _save_round(self, round_idx: int):
        if not self.cfg.FED.CHECKPOINT_EVERY_ROUND:
            return
        if self.cfg.TRAIN.CHECKPOINT_BACKEND == "orbax":
            print("[FED] orbax-checkpoint unavailable; falling back to pickle")
        checkpoint = {
            "epoch": (round_idx + 1) * self.local_epochs,
            "state_dict": flatten_params(self.global_weights),
            "optimizer": None,
            "scheduler": None,
            "val_result": None,
            "cfg": self.cfg.dump(),
        }
        save_checkpoint(checkpoint, osp.join(self.cfg.OUTPUT_DIR, AGGREGATOR_DIR),
                        model_name=f"model.pth.tar-round{round_idx + 1}")

    def _train_sequential(self):
        start_round = self._resume_round()
        for round_idx in range(start_round, self.num_rounds):
            print(f"\n--- Federated Round {round_idx + 1}/{self.num_rounds} ---")

            if self.check_weights_valid(self.global_weights):
                self.broadcast_weights(self.global_weights, round_idx)
            else:
                print("Invalid global weights detected! Skipping round.")
                self.nan_stats["skipped_rounds"] += 1
                continue

            local_trees = []
            valid_clients = 0
            round_losses = []

            for i, trainer in enumerate(self.clients):
                print(f"[Client {i}] local training ...")
                start = round_idx * self.local_epochs
                stop = (round_idx + 1) * self.local_epochs
                last_epoch_loss = 0.0
                try:
                    for ep in range(start, stop):
                        res = trainer.run_epoch(ep)
                        last_epoch_loss = res.get("avg_loss", 0.0)
                # RuntimeError only, like the reference (:204-206, :262-264):
                # CUDA errors raise RuntimeError; anything else (loader I/O, a
                # configuration fault) ends the run instead of being absorbed
                # as a failed client
                except RuntimeError as e:
                    print(f"Client {i} failed training: {e}")
                    self.nan_stats["failed_clients"].append(i)
                    continue

                round_losses.append(last_epoch_loss)

                if self.check_weights_valid(trainer.trainable):
                    local_trees.append(trainer.trainable)
                    valid_clients += 1
                else:
                    print(f"Client {i} produced invalid weights, skipping aggregation")
                    trainer.trainable = copy_tree(self.global_weights)

            if round_losses:
                avg = sum(round_losses) / len(round_losses)
                print(f"[Round {round_idx + 1}] Avg local training loss = {avg:.4f}")

            if valid_clients > 0:
                self.global_weights = safe_average_trees(local_trees)
                self.nan_stats["total_updates"] += 1
            else:
                print("All clients failed! Reverting to previous global model.")
                self.nan_stats["skipped_rounds"] += 1

            if self.check_weights_valid(self.global_weights):
                self.broadcast_weights(self.global_weights, round_idx, advance=True)
                test_res = self.clients[0].test()
                print(
                    f"[Round {round_idx + 1}] Test accuracy (client 0) = "
                    f"{test_res['accuracy']:.2f}%"
                )
            else:
                print("Global weights invalid after aggregation, skipping test.")

            self._save_round(round_idx)

        self.finalize_training()

    # ------------------------------------------------------------------
    # C') the parallel round loop: clients in lockstep on a client mesh
    #     (reference's sequential loop, the JAX package's SPMD loop)
    # ------------------------------------------------------------------
    def _train_parallel(self):
        C = self.num_clients
        mesh = _mesh.make_mesh_from_cfg(self.cfg, C, _mesh.visible_devices(self.device))
        print(f"[FED] parallel clients over mesh {dict(mesh.shape)}")
        client0 = self.clients[0]
        tx = client0.tx
        sched = client0.sched_fn
        step = build_parallel_fed_step(client0.loss_fn, tx, mesh,
                                       impl=getattr(self.cfg.TPU, "FED_STEP_IMPL", "auto"))
        frozen = client0.frozen
        global_tree = self.global_weights

        def lr_of(epoch):
            return torch.full((C,), sched(epoch), dtype=torch.float32, device=self.device)

        def broadcast(global_tree):
            # the sequential broadcast's schedule quirk: the first local
            # epoch of each round runs at sched(0) whatever the global epoch
            stacked = stack_client_trees([global_tree] * C)
            opt = stack_client_trees([tx.init(global_tree)] * C)
            opt["lr"] = lr_of(0)
            return stacked, opt

        def cycled(loader, n_steps):
            """Exactly ``n_steps`` batches, the loader restarted (a fresh
            shuffle) when it runs dry: the lockstep runs every client for
            the largest client's epoch instead of truncating to the
            smallest (the sequential loop runs each client's own epoch)."""
            done = 0
            while done < n_steps:
                progressed = False
                for b in loader:
                    progressed = True
                    yield b
                    done += 1
                    if done == n_steps:
                        return
                if not progressed:
                    raise ValueError(
                        "a client realizes zero train batches (shard smaller than "
                        "DATALOADER.TRAIN_X.BATCH_SIZE with drop_last) — shrink the "
                        "batch size or use the sequential round loop")

        def stacked_batches(epoch_loaders_steps):
            """The clients' batches of each step stacked to ``(C, B, ...)``."""
            for steps in zip(*epoch_loaders_steps):
                parsed = [trainer.parse_batch_train(b) for trainer, b in zip(self.clients, steps)]
                keys = set(parsed[0])
                for ci, p in enumerate(parsed[1:], 1):
                    if set(p) != keys:
                        raise ValueError(
                            "FED.PARALLEL_CLIENTS requires homogeneous batch structure "
                            f"across clients (client 0 has {sorted(keys)}, client {ci} has "
                            f"{sorted(p)} — e.g. caption availability differs). Use the "
                            "sequential round loop (FED.PARALLEL_CLIENTS False) for "
                            "heterogeneous clients.")
                yield {k: torch.stack([p[k] for p in parsed]) for k in parsed[0]}

        start_round = self._resume_round()
        if start_round:
            global_tree = self.global_weights
        lens = [len(t.train_loader_x) for t in self.clients]
        steps_per_epoch = max(lens)
        if len(set(lens)) > 1:
            print(f"[FED] client epoch lengths differ {lens}; shorter clients cycle "
                  f"(reshuffled) to {steps_per_epoch} steps so the SPMD lockstep covers "
                  "every client's full epoch")

        for round_idx in range(start_round, self.num_rounds):
            print(f"\n--- Federated Round {round_idx + 1}/{self.num_rounds} (parallel) ---")
            if not self.check_weights_valid(global_tree):
                print("Invalid global weights detected! Skipping round.")
                self.nan_stats["skipped_rounds"] += 1
                continue

            epoch0 = round_idx * self.local_epochs
            stacked, opt = broadcast(global_tree)

            # one program computes every client's step, so a runtime error
            # mid-round is not one client's: the round fails loudly (no
            # failed_clients accounting) and points at the sequential loop;
            # invalid weights are still handled per client by the gate below
            try:
                losses = None
                for le in range(self.local_epochs):
                    loaders = [cycled(t.train_loader_x, steps_per_epoch) for t in self.clients]
                    for batch in stacked_batches(loaders):
                        stacked, opt, losses = step(stacked, frozen, opt, batch)
                    # the per-epoch cosine step at the global epoch
                    opt["lr"] = lr_of(epoch0 + le + 1)
                if losses is not None:
                    # the read is where an asynchronous CUDA error of the
                    # steps above surfaces: inside the contract's region
                    loss_vals = losses.cpu().numpy()
                    print(f"[Round {round_idx + 1}] last-step losses per client = "
                          f"{np.round(loss_vals, 4).tolist()}")
            except RuntimeError as e:
                raise RuntimeError(
                    f"parallel federated round {round_idx + 1} failed mid-round; the "
                    "SPMD lockstep cannot attribute a runtime error to one client — use "
                    "FED.PARALLEL_CLIENTS False for per-client failure isolation") from e

            # the validity gate, then FedAvg over the client axis
            if self.check_weights_valid(stacked):
                global_tree = unstack_client_trees(fedavg_over_clients(stacked), 1)[0]
                self.nan_stats["total_updates"] += 1
            else:
                # per client, as the sequential gate: an invalid client is
                # left out (not counted failed: that list is for exceptions)
                valid = []
                for ci, t in enumerate(unstack_client_trees(stacked, C)):
                    if self.check_weights_valid(t):
                        valid.append(t)
                    else:
                        print(f"Client {ci} produced invalid weights, skipping aggregation")
                if valid:
                    global_tree = safe_average_trees(valid)
                    self.nan_stats["total_updates"] += 1
                else:
                    print("All clients failed! Reverting to previous global model.")
                    self.nan_stats["skipped_rounds"] += 1

            # the round's test on client 0 and its checkpoint, as the
            # sequential loop does
            self.global_weights = copy_tree(global_tree)
            if self.check_weights_valid(global_tree):
                self.broadcast_weights(self.global_weights, round_idx, advance=True)
                test_res = self.clients[0].test()
                print(f"[Round {round_idx + 1}] Test accuracy (client 0) = "
                      f"{test_res['accuracy']:.2f}%")
            else:
                print("Global weights invalid after aggregation, skipping test.")
            self._save_round(round_idx)

        self.global_weights = copy_tree(global_tree)
        self.finalize_training()

    # ------------------------------------------------------------------
    # D) utilities
    # ------------------------------------------------------------------
    def check_weights_valid(self, tree) -> bool:
        return tree_finite(tree)

    def broadcast_weights(self, global_tree, round_idx: int = 0, advance: bool = False):
        """Load the global weights into every client, drop the optimizer's
        momentum and rebuild the schedule (reference :327-339).

        The reference's quirk, kept: it rebuilds the torch scheduler (whose
        construction sets the LR to the epoch-0 value, the warmup LR) and
        then sets ``last_epoch`` without refreshing the LR, so the first
        local epoch of every round runs at ``sched(0)``; each epoch's
        ``update_lr`` then lands on the cosine value of the global epoch."""
        epoch = (round_idx + (1 if advance else 0)) * self.local_epochs
        for trainer in self.clients:
            trainer.trainable = copy_tree(global_tree)
            trainer.invalidate_eval_cache()
            trainer.reset_optimizer_state()
            trainer.set_epoch_lr(0)
            trainer.epoch = epoch

    def finalize_training(self):
        print("\nTraining Summary:")
        print(f"Completed Rounds: {self.nan_stats['total_updates']}")
        print(f"Skipped Rounds: {self.nan_stats['skipped_rounds']}")
        # the reference's formula (:345): the list accumulates over rounds
        # and the denominator is num_clients, so the rate can pass 100 %
        fail_rate = len(self.nan_stats["failed_clients"]) / max(1, self.num_clients)
        print(f"Client Failure Rate: {fail_rate:.1%}")
        # the end signal precedes the final test, which parse_test_res reads
        print("Finished training")

        if self.check_weights_valid(self.global_weights):
            self.broadcast_weights(self.global_weights, self.num_rounds)
            result = self.clients[0].test()
            print("Final test result:", result)
            self.before_save()
            self.save_model()
        else:
            print("Final global invalid, no test.")

    def before_save(self):
        """The global weights into every client's registered slot."""
        for trainer in self.clients:
            trainer.trainable = copy_tree(self.global_weights)

    def save_model(self, epoch=None, directory="", is_best=False, val_result=None):
        if not directory:
            directory = self.cfg.OUTPUT_DIR
        state_dict = flatten_params(self.global_weights)
        # the class-conditioned constants, as the clients save them
        sd_client = self.clients[0]._get_state()["state_dict"]
        for k in ("prompt_learner.token_prefix", "prompt_learner.token_suffix"):
            if k in sd_client:
                state_dict[k] = sd_client[k]
        checkpoint = {
            "epoch": self.cfg.OPTIM.MAX_EPOCH,
            "state_dict": state_dict,
            "optimizer": None,
            "scheduler": None,
            "val_result": val_result,
            "cfg": self.cfg.dump(),
        }
        target_dir = osp.join(directory, AGGREGATOR_DIR)
        save_checkpoint(checkpoint, target_dir, is_best=is_best,
                        model_name=f"model.pth.tar-{self.cfg.OPTIM.MAX_EPOCH}")
        if self.cfg.VERBOSE:
            print(f"Model saved to {target_dir}")

    def load_model(self, directory, epoch=None):
        if not directory:
            print("Skipping load_model, no pretrained path given")
            return
        model_file = f"model.pth.tar-{epoch}" if epoch is not None else "model.pth.tar"
        path = osp.join(directory, AGGREGATOR_DIR, model_file)
        if not osp.exists(path):
            # the default save carries MAX_EPOCH in its name
            alt = osp.join(directory, AGGREGATOR_DIR, f"model.pth.tar-{self.cfg.OPTIM.MAX_EPOCH}")
            if not osp.exists(alt):
                raise FileNotFoundError(f"Model not found at {path}")
            path = alt
        ckpt = load_checkpoint(path)
        flat = drop_class_conditioned(ckpt["state_dict"])
        self.global_weights, _ = unflatten_into(self.global_weights, flat)
        print(f"Loaded aggregator weights from '{path}' (epoch={ckpt.get('epoch')}).")
        if self.check_weights_valid(self.global_weights):
            self.broadcast_weights(self.global_weights, 0)
            print("Broadcasted loaded global weights.")
        else:
            print("Warning: loaded global weights invalid! Skipping broadcast.")

    # -- debug helpers (reference :414-491) -----------------------------------
    def debug_print_samples(self, data_manager, subset="train_x", max_per_class=5):
        data_subset = getattr(data_manager.dataset, subset, None)
        if not data_subset:
            print(f"No data found for subset='{subset}'!")
            return
        class_dict = defaultdict(list)
        for d in data_subset:
            class_dict[d.classname].append(d)
        print(f"\n--- Debugging {subset.upper()} ---")
        for cname, samples in class_dict.items():
            print(f"\nClass '{cname}' ({len(samples)} samples)")
            for i, datum in enumerate(samples[:max_per_class]):
                print(f"  Sample {i + 1} | label={datum.label}, "
                      f"caption='{datum.caption}', impath='{datum.impath}'")
        print("--- End of Debug ---\n")

    def debug_save_samples_images(self, data_manager, subset="train_x",
                                  output_dir="debug_samples", max_per_class=5):
        from PIL import Image

        data_subset = getattr(data_manager.dataset, subset, None)
        if not data_subset:
            print(f"No data found for subset='{subset}'!")
            return
        class_dict = defaultdict(list)
        for d in data_subset:
            class_dict[d.classname].append(d)
        subset_dir = os.path.join(output_dir, subset)
        os.makedirs(subset_dir, exist_ok=True)
        for cname, samples in class_dict.items():
            class_dir = os.path.join(subset_dir, cname)
            os.makedirs(class_dir, exist_ok=True)
            for i, datum in enumerate(samples[:max_per_class]):
                img = Image.open(datum.impath).convert("RGB")
                img.save(os.path.join(class_dir, f"sample_{i + 1}_label_{datum.label}.jpg"))
        print(f"Saved up to {max_per_class} images per class to: {subset_dir}")

    def debug_clients_data(self):
        for i, dm in enumerate(self.client_data_managers):
            print(f"\n=== Client {i} ===")
            self.debug_print_samples(dm, subset="train_x")

    def test(self, split=None):
        if self.check_weights_valid(self.global_weights):
            self.broadcast_weights(self.global_weights, self.num_rounds)
            return self.clients[0].test(split)
        print("Global weights invalid, skipping test.")
        return {}
