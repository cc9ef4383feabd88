"""The port's multi-process layer (``parallel/multihost.py`` and
``TPU.DATA_PARALLEL_MULTIHOST`` in ``engine/trainer.py``) in two real CPU
processes on ``torch.distributed``'s Gloo backend, in the style of
``tests/test_multihost.py``.

The children import torch and the port only, never JAX. They meet through a
``file://`` init method in the test's temporary directory, so that parallel
test workers never race for a port. One pair of children runs once per
module and writes what each process saw to a JSON file; the tests read it.
Each child builds the port's CoOp trainer (Tiny, Synthetic, fp32) from the
same weights as the parent's single-process runs of the port and of the JAX
package, and takes two data-parallel steps on its half of a batch of eight:
once on one local device, and once with ``parallel/mesh.py::visible_devices``
replaced by two CPU devices, so that each process splits its half over them
(each child is launched as the one process of its host,
``LOCAL_WORLD_SIZE=1``, which drives every device it sees).
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from federated_multi_modal_tpu.config import get_cfg_default as jax_defaults
from federated_multi_modal_tpu.engine import build_trainer as jax_build_trainer
from federated_multi_modal_tpu.engine.checkpoint import flatten_params as jax_flatten
from federated_multi_modal_tpu.engine.checkpoint import save_checkpoint as jax_save
from federated_multi_modal_tpu_torch.config import get_cfg_default
from federated_multi_modal_tpu_torch.engine import build_trainer
from federated_multi_modal_tpu_torch.models import params as port_params
from federated_multi_modal_tpu_torch.parallel import multihost
from test_torch_fed import MODULE_GLOBALS

REPO = Path(__file__).resolve().parents[1]
# tests/test_parallel.py::test_single_site_data_parallel_equivalence's limits
# (the two-process step against the one-process full-batch step)
LOSS_ATOL, CTX_ATOL = 1e-4, 1e-5
STEPS, BATCH = 2, 8

CHILD = textwrap.dedent(
    """
    import json, os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)

    from federated_multi_modal_tpu_torch.parallel import multihost

    out = {"initialized": multihost.initialize_multihost()}
    rank = torch.distributed.get_rank()
    out.update(rank=rank, count=multihost.process_count(), main=multihost.is_main_process(),
               backend=torch.distributed.get_backend())
    multihost.sync_hosts("start")

    import federated_multi_modal_tpu_torch.trainers  # noqa: F401
    from federated_multi_modal_tpu_torch.config import get_cfg_default
    from federated_multi_modal_tpu_torch.engine import build_trainer

    spec = json.loads(os.environ["CHILD_SPEC"])
    cfg = get_cfg_default()
    cfg.merge_from_list(spec["opts"])
    cfg.OUTPUT_DIR = os.path.join(spec["dir"], f"out{rank}")
    cfg.freeze()
    trainer = build_trainer(cfg, device="cpu")
    out["dp_multihost"] = trainer._dp_multihost
    data = np.load(spec["batch"])
    half = slice(rank * len(data["label"]) // 2, (rank + 1) * len(data["label"]) // 2)
    batch = {"image": torch.from_numpy(data["image"][half]),
             "label": torch.from_numpy(data["label"][half])}
    out["losses"] = [trainer.train_step(batch)["loss"] for _ in range(spec["steps"])]
    out["ctx"] = trainer.trainable["prompt_learner"]["ctx"].tolist()
    out["local_logits_rows"] = int(trainer.model_inference(batch["image"]).shape[0])

    # two local devices a process: each process splits its half over them
    from federated_multi_modal_tpu_torch.parallel import mesh
    visible = mesh.visible_devices
    mesh.visible_devices = lambda device=None: [torch.device("cpu")] * 2
    cfg2 = cfg.clone()
    cfg2.defrost()
    cfg2.OUTPUT_DIR = os.path.join(spec["dir"], f"out_local2_{rank}")
    cfg2.freeze()
    local2 = build_trainer(cfg2, device="cpu")
    out["local2_devices"] = [str(d) for d in local2._dp_devices]
    out["local2_shards"] = [int(b["label"].shape[0]) for _, b in local2._dp_shard(batch)]
    out["local2_losses"] = [local2.train_step(batch)["loss"] for _ in range(spec["steps"])]
    out["local2_ctx"] = local2.trainable["prompt_learner"]["ctx"].tolist()
    out["local2_logits_rows"] = int(local2.model_inference(batch["image"]).shape[0])
    try:
        local2._dp_shard({"x": torch.zeros(3, 4)})
        out["local2_odd_leaf_error"] = None
    except ValueError as e:
        out["local2_odd_leaf_error"] = str(e)
    mesh.visible_devices = visible
    del local2

    # save_model writes on process 0 only
    trainer.save_model(0, directory=os.path.join(spec["dir"], f"saved{rank}"))
    multihost.sync_hosts("saved")
    out["saved"] = {r: os.path.isdir(os.path.join(spec["dir"], f"saved{r}")) for r in (0, 1)}

    def raises(fn, text):
        try:
            fn()
        except ValueError as e:
            return text in str(e)
        return False

    # a batch leaf this process cannot shard, and 0-d leaves under the
    # verify knob: equal ones pass, differing ones raise on every process
    out["empty_leaf_raises"] = raises(
        lambda: trainer._dp_shard({"x": torch.zeros(0, 4)}), "divisible")
    trainer._dp_verify_scalars = True
    trainer._dp_shard({"x": batch["label"], "s": torch.tensor(2.0)})
    out["same_scalar_passes"] = True
    out["differing_scalar_raises"] = raises(
        lambda: trainer._dp_shard({"x": batch["label"], "s": torch.tensor(1.0 + rank)}),
        "differs across processes")
    # the knob set on one process only is refused at set-up on both
    os.environ["FMM_TPU_MULTIHOST_VERIFY_SCALARS"] = "1" if rank == 0 else "0"
    out["partial_knob_raises"] = raises(lambda: trainer._setup_data_parallel(cfg),
                                        "identical on every process")

    # the federated aggregator refuses to run under several processes
    from federated_multi_modal_tpu_torch.trainers.maple_fed import MaPLeFederated

    fed = MaPLeFederated.__new__(MaPLeFederated)
    fed.cfg = get_cfg_default()
    try:
        fed.train()
        out["fed_guard"] = False
    except RuntimeError as e:
        out["fed_guard"] = "single-process by design" in str(e)
    out["jax_imported"] = sorted(m for m in sys.modules
                                 if m.split(".")[0] in ("jax", "jaxlib", "optax",
                                                        "federated_multi_modal_tpu"))
    with open(os.path.join(spec["dir"], f"result{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()
    """
)


def _coop_opts(data_root, weights, init, dp_multihost):
    return ["DATASET.ROOT", str(data_root), "DATASET.NAME", "Synthetic",
            "MODEL.BACKBONE.NAME", "Tiny", "MODEL.BACKBONE.WEIGHTS_PATH", str(weights),
            "MODEL.INIT_WEIGHTS", str(init), "INPUT.SIZE", "(32, 32)", "INPUT.CANVAS_SIZE", "40",
            "DATALOADER.TRAIN_X.BATCH_SIZE", str(BATCH), "DATALOADER.TEST.BATCH_SIZE", "8",
            "OPTIM.MAX_EPOCH", "1", "OPTIM.LR", "0.02", "TRAIN.PRINT_FREQ", "100",
            "TRAINER.NAME", "CoOp", "TRAINER.COOP.PREC", "fp32", "SEED", "1", "VERBOSE", "False",
            "TPU.DATA_PARALLEL", "True", "TPU.DATA_PARALLEL_MULTIHOST", str(dp_multihost)]


def _steps(trainer, batch, to):
    losses = [trainer.train_step({k: to(v) for k, v in batch.items()})["loss"]
              for _ in range(STEPS)]
    return losses, np.asarray(trainer.trainable["prompt_learner"]["ctx"], np.float32)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    """The JAX package's and the port's single-process full-batch runs, then
    the two children's runs on halves of the same batch."""
    d = tmp_path_factory.mktemp("multihost")
    arch = port_params.BACKBONE_CONFIGS["Tiny"]
    tree = port_params.init_clip_params(arch, torch.Generator().manual_seed(11),
                                        dtype_policy=False)
    weights = d / "tiny_openai.pt"
    torch.save(port_params.export_openai_state_dict(tree, arch), weights)
    rng = np.random.default_rng(3)
    batch = {"image": rng.standard_normal((BATCH, 32, 32, 3)).astype(np.float32),
             "label": (np.arange(BATCH) % 4).astype(np.int32)}
    np.savez(d / "batch.npz", **batch)
    data_root = d / "data"
    with pytest.MonkeyPatch.context() as mp:
        for module, attr in MODULE_GLOBALS:
            mp.setattr(module, attr, getattr(module, attr))
        jcfg = jax_defaults()
        jcfg.merge_from_list(_coop_opts(data_root, weights, "", False))
        jcfg.TPU.DATA_PARALLEL = False
        jcfg.OUTPUT_DIR = str(d / "jax")
        ref = jax_build_trainer(jcfg)
        init = d / "init" / "init.pth.tar"
        jax_save({"epoch": 0, "state_dict": jax_flatten(ref.trainable)}, str(init.parent),
                 model_name=init.name)
        jax_run = _steps(ref, batch, jnp.asarray)
        pcfg = get_cfg_default()
        pcfg.merge_from_list(_coop_opts(data_root, weights, init, False))
        pcfg.OUTPUT_DIR = str(d / "port")
        port_run = _steps(build_trainer(pcfg, device="cpu"), batch, torch.from_numpy)
    spec = {"opts": _coop_opts(data_root, weights, init, True), "dir": str(d),
            "batch": str(d / "batch.npz"), "steps": STEPS}
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items()
               if k not in ("FMM_TPU_MULTIHOST_VERIFY_SCALARS", "MASTER_ADDR", "MASTER_PORT",
                            "LOCAL_WORLD_SIZE", "LOCAL_RANK")}
        env.update(PYTHONPATH=str(REPO) + os.pathsep + env.get("PYTHONPATH", ""),
                   JAX_COORDINATOR_ADDRESS=f"file://{d / 'pg_store'}",
                   JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(rank), LOCAL_WORLD_SIZE="1",
                   CHILD_SPEC=json.dumps(spec), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, "-c", CHILD], env=env, cwd=str(d),
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multi-process child hung:\n" + "\n---\n".join(outs))
    if any(p.returncode for p in procs):
        pytest.fail("multi-process child failed:\n" + "\n---\n".join(outs))
    results = [json.loads((d / f"result{r}.json").read_text()) for r in range(2)]
    return {"jax": jax_run, "port": port_run, "children": results, "dir": d}


def test_two_process_helpers_and_rank0_writes(two):
    """``initialize_multihost`` from the JAX package's variables starts a
    Gloo group of two; each process knows its rank and whether it is the
    main one; after the barrier both see that only process 0 wrote its
    checkpoint; nothing of JAX was imported."""
    for rank, r in enumerate(two["children"]):
        assert r["initialized"] is True and r["count"] == 2 and r["backend"] == "gloo"
        assert r["rank"] == rank and r["main"] == (rank == 0)
        assert r["saved"] == {"0": True, "1": False}
        assert r["jax_imported"] == []
    assert list((two["dir"] / "saved0" / "prompt_learner").glob("model.pth.tar-1"))


def test_two_process_data_parallel_step_matches_full_batch(two):
    """Each process steps on its half of the batch with
    ``TPU.DATA_PARALLEL_MULTIHOST``: after two steps both hold the same
    ``ctx`` and loss as one process's full-batch steps of the port and of
    the JAX package; eval stays process-local."""
    jax_losses, jax_ctx = two["jax"]
    port_losses, port_ctx = two["port"]
    np.testing.assert_allclose(port_losses, jax_losses, atol=LOSS_ATOL)
    np.testing.assert_allclose(port_ctx, jax_ctx, atol=CTX_ATOL)
    for r in two["children"]:
        assert r["dp_multihost"] is True
        np.testing.assert_allclose(r["losses"], port_losses, atol=LOSS_ATOL)
        np.testing.assert_allclose(r["losses"], jax_losses, atol=LOSS_ATOL)
        np.testing.assert_allclose(np.asarray(r["ctx"], np.float32), port_ctx, atol=CTX_ATOL)
        np.testing.assert_allclose(np.asarray(r["ctx"], np.float32), jax_ctx, atol=CTX_ATOL)
        assert r["local_logits_rows"] == BATCH // 2
    assert two["children"][0]["ctx"] == two["children"][1]["ctx"]


def test_two_process_two_local_devices_match_full_batch(two):
    """With two local devices a process (``visible_devices`` replaced by two
    CPU devices in each child), each process splits its half of the batch
    over them: the shards' mean, then the mean over the processes. After
    two steps both processes hold the same bits, within ``LOSS_ATOL`` and
    ``CTX_ATOL`` of the JAX package's one-process full-batch steps; eval
    stays process-local, on the process's half."""
    jax_losses, jax_ctx = two["jax"]
    for r in two["children"]:
        assert r["local2_devices"] == ["cpu", "cpu"]
        assert r["local2_shards"] == [BATCH // 4, BATCH // 4]
        np.testing.assert_allclose(r["local2_losses"], jax_losses, atol=LOSS_ATOL)
        np.testing.assert_allclose(np.asarray(r["local2_ctx"], np.float32), jax_ctx,
                                   atol=CTX_ATOL)
        assert r["local2_logits_rows"] == BATCH // 2
    first, second = two["children"]
    assert first["local2_ctx"] == second["local2_ctx"]
    assert first["local2_losses"] == second["local2_losses"]


def test_two_process_local_count_that_does_not_divide_raises(two):
    """A batch leaf whose axis 0 the two local devices do not divide raises
    with the JAX package's message, naming the local device count."""
    for r in two["children"]:
        assert r["local2_odd_leaf_error"] == (
            "multi-host DP requires every batch leaf's axis 0 (3) to be divisible by the "
            "local device count (2); pad the batch or change DATALOADER.*.BATCH_SIZE")


def test_two_process_batch_checks_and_verify_scalars(two):
    """An empty batch leaf raises; under ``FMM_TPU_MULTIHOST_VERIFY_SCALARS``
    an equal 0-d leaf passes and a differing one raises on every process; the
    knob set on one process only is refused at set-up on both."""
    for r in two["children"]:
        assert r["empty_leaf_raises"] and r["same_scalar_passes"]
        assert r["differing_scalar_raises"] and r["partial_knob_raises"]


def test_two_process_federated_train_guard(two):
    """``MaPLeFederated.train()`` under two processes refuses with the
    single-process error on each."""
    assert all(r["fed_guard"] for r in two["children"])


def test_single_process_helpers(monkeypatch):
    """With nothing configured ``initialize_multihost`` is a no-op that
    returns ``False``; this process is the main one and the barrier returns
    at once."""
    for name in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
                 "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize_multihost() is False
    assert multihost.is_main_process() and multihost.process_count() == 1
    multihost.sync_hosts("test")


@pytest.mark.parametrize("kwargs", [
    {"coordinator_address": "bogus://nowhere", "num_processes": 2, "process_id": 0},
    {"coordinator_address": "127.0.0.1:1", "num_processes": 2},
], ids=["start_fails", "no_process_id"])
def test_configured_start_that_cannot_happen_raises(kwargs, monkeypatch):
    """A run configured for several processes that cannot start raises
    instead of going on as one more process 0."""
    monkeypatch.delenv("JAX_PROCESS_ID", raising=False)
    with pytest.raises(RuntimeError, match="process"):
        multihost.initialize_multihost(**kwargs)
    assert not torch.distributed.is_initialized()
