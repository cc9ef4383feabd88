"""The port's distributed layer against the JAX package's, on the CPU: the
client mesh, ``build_parallel_fed_step`` in both implementations, the
parallel ``MaPLeFederated`` round loop (its rounds, resume across packages,
its errors and fallback), single-process ``TPU.DATA_PARALLEL``,
``TPU.REMAT``, ``TRAIN.PROFILE_DIR`` and the orbax decision.

The JAX package runs on the eight virtual CPU devices of
``tests/conftest.py``; the port's ``parallel/mesh.py::visible_devices`` is
patched to eight CPU devices to mirror them, so both lay out the same
meshes and split batches the same way (every "device" of the port is the
CPU). Weights cross from JAX with ``load_jax_params`` or, for the trainers,
through ``MODEL.BACKBONE.WEIGHTS_PATH`` and ``MODEL.INIT_WEIGHTS`` as in
``tests/test_torch_fed.py``, whose helpers this module uses.
"""

import collections
import contextlib
import io
import json
import os
import re
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import federated_multi_modal_tpu.parallel as jax_parallel
from federated_multi_modal_tpu import flagship as jax_flagship
from federated_multi_modal_tpu.config import get_cfg_default as jax_defaults
from federated_multi_modal_tpu.engine import build_trainer as jax_build_trainer
from federated_multi_modal_tpu.engine.checkpoint import flatten_params as jax_flatten
from federated_multi_modal_tpu.engine.checkpoint import save_checkpoint as jax_save
from federated_multi_modal_tpu.parallel import mesh as jax_mesh
from federated_multi_modal_tpu.trainers import maple_fed as jax_fed
from federated_multi_modal_tpu_torch import flagship as port_flagship
from federated_multi_modal_tpu_torch import parallel as port_parallel
from federated_multi_modal_tpu_torch.config import get_cfg_default
from federated_multi_modal_tpu_torch.engine import build_trainer
from federated_multi_modal_tpu_torch.engine.trainer import loss_grads_and_aux
from federated_multi_modal_tpu_torch.engine.tree import flatten
from federated_multi_modal_tpu_torch.models import params as port_params
from federated_multi_modal_tpu_torch.parallel import mesh as port_mesh
from federated_multi_modal_tpu_torch.trainers import maple_fed as port_fed
from test_torch_fed import (
    AGG,
    MODULE_GLOBALS,
    _assert_weights_close,
    _cfg,
    _checkpoints,
    _flat,
    run,
)

CPUS = [torch.device("cpu")] * 8
# JAX's own limits for its two fed-step implementations against each other
# (tests/test_parallel.py::test_fed_step_impl_equivalence)
STEP_RTOL, STEP_ATOL = 1e-3, 1e-6
# tests/test_parallel.py::test_single_site_data_parallel_equivalence
DP_LOSS_ATOL, DP_CTX_ATOL = 1e-4, 1e-5
# tests/test_torch_train.py's whole-step limits (fp32, the same arithmetic in
# another order)
LOSS_RTOL, GRAD_TOL = 2e-6, 5e-5


def _tree_finite_leaf_by_leaf(tree) -> bool:
    """The JAX package's ``engine/trainer.py::tree_finite`` (the value is the
    same), reading each leaf's flag before the next leaf's program starts.
    Its own version has one collective program per leaf in flight at once;
    on the eight virtual CPU devices, under load, XLA's CPU runtime can run
    some devices of several of them on its thread pool, each waiting at its
    all-reduce for devices left without a thread, until the rendezvous
    timeout aborts the process (``rendezvous.cc``: "Termination timeout for
    `all reduce ...` of 40 seconds exceeded")."""
    leaves = [x for x in jax.tree_util.tree_leaves(tree) if x is not None]
    return all(bool(jax.device_get(jnp.all(jnp.isfinite(x.astype(jnp.float32)))))
               for x in leaves)


@pytest.fixture(scope="module", autouse=True)
def _jax_validity_gate_leaf_by_leaf():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_fed, "tree_finite", _tree_finite_leaf_by_leaf)
        yield


@pytest.fixture(autouse=True)
def _module_globals(monkeypatch):
    """Each trainer sets its package's routing globals; put them back. The
    port sees eight CPU devices, as JAX does."""
    for module, attr in MODULE_GLOBALS:
        monkeypatch.setattr(module, attr, getattr(module, attr))
    monkeypatch.setattr(port_mesh, "visible_devices", lambda device=None: list(CPUS))


# -- the mesh ----------------------------------------------------------------------

MESH_CASES = {
    "auto_2": (2, None, None),
    "auto_3_falls_back": (3, None, None),
    "shape_2x4": (2, (2, 4), ("client", "data")),
    "client_axis_not_clients": (2, (4, 2), ("client", "data")),
    "wrong_device_count": (3, (3, 4), ("client", "data")),
    "rank_differs": (2, (2, 4), ("client",)),
    "axes_lack_data": (2, (2, 4), ("client", "model")),
    "empty_shape": (2, (), ("client", "data")),
}


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_mesh_matches_jax(case):
    """``make_client_mesh`` and ``make_mesh_from_cfg`` over eight devices:
    the same shape, or the same ``ValueError`` message."""
    clients, shape, axes = MESH_CASES[case]
    if shape is None:
        want = jax_mesh.make_client_mesh(clients)
        got = port_mesh.make_client_mesh(clients, CPUS)
        assert got.shape == dict(want.shape) and got.axis_names == tuple(want.axis_names)
        assert got.devices.shape == want.devices.shape
        return
    cfgs = []
    for defaults in (jax_defaults, get_cfg_default):
        cfg = defaults()
        cfg.TPU.MESH_SHAPE = shape
        cfg.TPU.MESH_AXES = axes
        cfgs.append(cfg)
    try:
        want = jax_mesh.make_mesh_from_cfg(cfgs[0], clients)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            port_mesh.make_mesh_from_cfg(cfgs[1], clients)
        assert str(got.value) == str(e)
        return
    got = port_mesh.make_mesh_from_cfg(cfgs[1], clients)
    assert got.shape == dict(want.shape)


# -- build_parallel_fed_step ------------------------------------------------------


@pytest.fixture(scope="module")
def fed_step_inputs():
    """The JAX program (Tiny, depth 3, no captions) with fp32 towers, two
    clients' batches of four (seeds 0 and 1, fp32 images), and the same
    weights and batches for the port."""
    prog = jax_flagship.build_maple_program(backbone="Tiny", depth=3, use_captions=False)

    def fp32(tree):
        return jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float32)
            if x is not None and jnp.issubdtype(x.dtype, jnp.inexact) else x,
            tree, is_leaf=lambda x: x is None)

    frozen = fp32(prog["frozen"])
    batches = [jax_flagship.example_batch(prog["arch"], batch_size=4, n_cls=prog["n_cls"],
                                          use_captions=False, seed=s) for s in (0, 1)]
    batch = {k: np.stack([np.asarray(b[k], np.float32 if k == "image" else None)
                          for b in batches]) for k in batches[0]}
    port_prog = port_flagship.build_maple_program(backbone="Tiny", depth=3,
                                                  use_captions=False, device="cpu")
    return {
        "jax": (prog, frozen, batch),
        "port": (port_prog,
                 port_params.load_jax_params(jax_flatten(prog["trainable"]), device="cpu"),
                 {"model": port_params.load_jax_params(jax_flatten(frozen["model"]),
                                                       device="cpu"),
                  "prompt_const": port_params.load_jax_params(
                      {k: np.asarray(v) for k, v in frozen["prompt_const"].items()},
                      device="cpu")},
                 {k: torch.from_numpy(v) for k, v in batch.items()}),
    }


def _jax_fed_step(inputs, impl, fedavg_every_step=False):
    """The JAX step on the (2, 4) mesh: losses, the trainable leaves and the
    momentum leaves, by checkpoint name, as numpy."""
    prog, frozen, batch = inputs
    mesh = jax_mesh.make_client_mesh(2)
    tx = jax_flagship.build_fed_optimizer(lr=0.05)

    def shard(tree, spec):
        return jax.tree_util.tree_map(
            lambda x: None if x is None else jax.device_put(x, NamedSharding(mesh, spec)),
            tree, is_leaf=lambda x: x is None)

    stacked = shard(jax_parallel.stack_client_trees([prog["trainable"]] * 2), P("client"))
    opt = shard(jax_parallel.stack_client_trees([tx.init(prog["trainable"])] * 2), P("client"))
    step = jax_parallel.build_parallel_fed_step(prog["loss_fn"], tx, mesh,
                                                fedavg_every_step=fedavg_every_step, impl=impl)
    s2, o2, losses = step(stacked, shard(frozen, P()), opt,
                          {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, P("client", "data")))
                           for k, v in batch.items()})
    trace = next(s.trace for s in o2.inner_state if hasattr(s, "trace"))
    return (np.asarray(losses), {k: np.asarray(v, np.float32) for k, v in jax_flatten(s2).items()},
            {k: np.asarray(v, np.float32) for k, v in jax_flatten(trace).items()})


def _port_fed_step(inputs, impl, batch=None, fedavg_every_step=False):
    prog, trainable, frozen, port_batch = inputs
    mesh = port_mesh.make_client_mesh(2, CPUS)
    tx = port_flagship.build_fed_optimizer(lr=0.05)
    stacked = port_parallel.stack_client_trees([trainable] * 2)
    opt = port_parallel.stack_client_trees([tx.init(trainable)] * 2)
    step = port_parallel.build_parallel_fed_step(prog["loss_fn"], tx, mesh,
                                                 fedavg_every_step=fedavg_every_step, impl=impl)
    s2, o2, losses = step(stacked, frozen, opt, port_batch if batch is None else batch)
    return (losses.numpy(), {k: v.float().numpy() for k, v in flatten(s2).items()},
            {k: v.float().numpy() for k, v in flatten(o2["trace"]).items()})


@pytest.mark.parametrize("impl", ["vmap", "shard_map"])
def test_parallel_fed_step_matches_jax(impl, fed_step_inputs):
    """Two clients on the (2, 4) mesh, one step each: the losses, every
    parameter and every momentum leaf within JAX's own limits between its
    two implementations; the clients diverge."""
    want = _jax_fed_step(fed_step_inputs["jax"], impl)
    got = _port_fed_step(fed_step_inputs["port"], impl)
    np.testing.assert_allclose(got[0], want[0], rtol=STEP_RTOL, atol=STEP_ATOL)
    assert got[0][0] != got[0][1]
    for g, w in zip(got[1:], want[1:]):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=STEP_RTOL, atol=STEP_ATOL, err_msg=k)
    ctx = got[1]["prompt_learner.ctx"]
    assert not np.allclose(ctx[0], ctx[1])


@pytest.mark.parametrize("impl", ["vmap", "shard_map"])
def test_fed_step_takes_a_batch_a_client(impl, fed_step_inputs):
    """The batch as a list of each client's batch gives the stacked batch's
    step bit for bit, under both implementations."""
    batch = fed_step_inputs["port"][3]
    per_client = [{k: v[c] for k, v in batch.items()} for c in range(2)]
    want = _port_fed_step(fed_step_inputs["port"], impl)
    got = _port_fed_step(fed_step_inputs["port"], impl, batch=per_client)
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_fed_step_nan_batch_keeps_client_state_and_fedavg_every_step(fed_step_inputs):
    """A NaN batch in client 1 leaves its parameters and momentum as they
    were while client 0 steps; ``fedavg_every_step`` averages the clients'
    parameters after the step (equal to FedAvg of the step without it)."""
    prog, trainable, frozen, batch = fed_step_inputs["port"]
    bad = dict(batch, image=batch["image"].clone())
    bad["image"][1] = float("nan")
    losses, params, trace = _port_fed_step(fed_step_inputs["port"], "vmap", batch=bad)
    assert np.isfinite(losses[0]) and not np.isfinite(losses[1])
    before = {k: v.numpy() for k, v in flatten(trainable).items()}
    for k, v in params.items():
        np.testing.assert_array_equal(v[1], before[k], err_msg=k)
        assert not trace[k][1].any(), k
    assert not np.array_equal(params["prompt_learner.ctx"][0], before["prompt_learner.ctx"])
    _, plain, _ = _port_fed_step(fed_step_inputs["port"], "vmap")
    _, averaged, _ = _port_fed_step(fed_step_inputs["port"], "vmap", fedavg_every_step=True)
    for k, v in plain.items():
        mean = (v.astype(np.float32).sum(0) * np.float32(0.5)).astype(v.dtype)
        np.testing.assert_array_equal(averaged[k][0], mean, err_msg=k)
        np.testing.assert_array_equal(averaged[k][1], mean, err_msg=k)


# -- the parallel round loop --------------------------------------------------------

ROUNDS = 2


def _parallel_cfg(defaults, data_root, out, weights, init=""):
    cfg = _cfg(defaults, data_root, out, weights, init)
    cfg.FED.PARALLEL_CLIENTS = True
    cfg.FED.NUM_ROUNDS = ROUNDS
    cfg.FED.LOCAL_EPOCHS = 1
    cfg.OPTIM.MAX_EPOCH = ROUNDS
    return cfg


def _last_step_losses(log: str) -> list:
    return [[float(x) for x in m.split(",")]
            for m in re.findall(r"last-step losses per client = \[([^\]]*)\]", log)]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A Tiny CLIP in OpenAI's state-dict layout, from a seed, and a data
    root for the Synthetic dataset."""
    d = tmp_path_factory.mktemp("weights")
    arch = port_params.BACKBONE_CONFIGS["Tiny"]
    tree = port_params.init_clip_params(arch, torch.Generator().manual_seed(11),
                                        dtype_policy=False)
    torch.save(port_params.export_openai_state_dict(tree, arch), d / "tiny_openai.pt")
    return d / "tiny_openai.pt", d / "data"


@pytest.fixture(scope="module")
def par(tmp_path_factory, weights):
    """A ``MaPLeFederated`` of each package with ``FED.PARALLEL_CLIENTS``
    on the same weights, and each one's run of ``ROUNDS`` parallel rounds of
    one local epoch (the log of each kept)."""
    d = tmp_path_factory.mktemp("par")
    weights, data_root = weights
    with pytest.MonkeyPatch.context() as mp:
        for module, attr in MODULE_GLOBALS:
            mp.setattr(module, attr, getattr(module, attr))
        mp.setattr(port_mesh, "visible_devices", lambda device=None: list(CPUS))
        ref = jax_build_trainer(_parallel_cfg(jax_defaults, data_root, d / "jax-build", weights))
        init = d / "init" / "init.pth.tar"
        jax_save({"epoch": 0, "state_dict": jax_flatten(ref.global_weights)},
                 str(init.parent), model_name=init.name)
        port = build_trainer(_parallel_cfg(get_cfg_default, data_root, d / "port-build",
                                           weights, init), device="cpu")
        for fed in (ref, port):
            fed.initial = (jax_fed if fed is ref else port_fed).copy_tree(fed.global_weights)
        runs, logs = {}, {}
        for who, fed in (("jax", ref), ("port", port)):
            log = io.StringIO()
            with contextlib.redirect_stdout(log):
                runs[who] = run(fed, d / who, rounds=ROUNDS, local_epochs=1)
            logs[who] = log.getvalue()
    return {"dir": d, "jax": ref, "port": port, "runs": runs, "logs": logs,
            "data_root": data_root}


def test_parallel_rounds_match_jax(par):
    """Both packages take the parallel loop over the (2, 4) mesh: the same
    last-step losses per client each round, the same ``nan_stats``, every
    round's test accuracy, every round checkpoint and the final global
    weights."""
    for who in ("jax", "port"):
        assert "[FED] parallel clients over mesh {'client': 2, 'data': 4}" in par["logs"][who]
    want, got = _last_step_losses(par["logs"]["jax"]), _last_step_losses(par["logs"]["port"])
    assert len(want) == ROUNDS and len(got) == ROUNDS
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert want[0][0] != want[0][1]
    g, w = par["runs"]["port"], par["runs"]["jax"]
    assert g["stats"] == w["stats"] == {"total_updates": ROUNDS, "failed_clients": [],
                                        "skipped_rounds": 0}
    assert g["tests"] == w["tests"] and len(w["tests"]) == ROUNDS + 1
    _assert_weights_close(g["final"], w["final"], "final")
    ckpt_got, ckpt_want = _checkpoints(par["dir"] / "port"), _checkpoints(par["dir"] / "jax")
    assert sorted(ckpt_got) == sorted(ckpt_want)
    for name, c in ckpt_want.items():
        _assert_weights_close({k: np.asarray(v, np.float32)
                               for k, v in ckpt_got[name]["state_dict"].items()},
                              {k: np.asarray(v, np.float32) for k, v in c["state_dict"].items()},
                              name)


def test_parallel_resume_from_the_other_packages_round(par, tmp_path):
    """Each package resumes its parallel loop from the other's round-1
    checkpoint and trains round 2 to the same weights and accuracies."""
    got = {}
    for who, other in (("port", "jax"), ("jax", "port")):
        src = tmp_path / f"{other}-round1" / AGG
        src.mkdir(parents=True)
        shutil.copy(par["dir"] / other / AGG / "model.pth.tar-round1", src)
        got[who] = run(par[who], tmp_path / f"{who}-resumed", resume=src.parent,
                       rounds=ROUNDS, local_epochs=1)
    assert got["jax"]["stats"] == got["port"]["stats"]
    assert got["jax"]["stats"]["total_updates"] == ROUNDS - 1
    assert got["port"]["tests"] == got["jax"]["tests"]
    _assert_weights_close(got["port"]["final"], got["jax"]["final"], "resumed")


class _Loader:
    """A train loader of the first ``n`` batches of ``loader`` (``n`` may be
    0: a client that realizes no batch)."""

    def __init__(self, loader, n):
        self.loader, self.n = loader, n

    def __len__(self):
        return self.n

    def __iter__(self):
        batches = iter(self.loader)
        try:
            for _ in range(self.n):
                yield next(batches)
        finally:
            batches.close()


LOOP_CASES = ["unequal_clients_cycle", "zero_batch_client", "heterogeneous_batches",
              "three_clients_fall_back"]


@pytest.mark.parametrize("case", LOOP_CASES)
def test_parallel_loop_cases_match_jax(case, par, monkeypatch, capsys):
    """The loop's rules in both packages, with each package's step replaced
    by one that records the stacked batches and leaves the clients as they
    are: a shorter client cycles to the longest client's steps; a client
    with no batch and batches of another structure raise the JAX package's
    ``ValueError``; three clients on eight devices fall back to the
    sequential rounds with its line."""
    seen = {}
    for who, pkg in (("jax", jax_parallel), ("port", port_fed)):
        fed = par[who]
        steps = seen.setdefault(who, [])

        def recording_step_maker(loss_fn, tx, mesh, steps=steps, **kwargs):
            def step(stacked, frozen, opt, batch):
                steps.append({k: tuple(v.shape) for k, v in batch.items()})
                C = next(iter(batch.values())).shape[0]
                return stacked, opt, jnp.zeros((C,)) if who == "jax" else torch.zeros(C)
            return step

        monkeypatch.setattr(pkg, "build_parallel_fed_step", recording_step_maker)
        monkeypatch.setattr(fed, "_train_sequential", lambda: "sequential")
        monkeypatch.setattr(fed, "finalize_training", lambda: None)
        cfg = fed.cfg.clone()
        cfg.defrost()
        cfg.FED.NUM_ROUNDS = 1
        cfg.OUTPUT_DIR = str(par["dir"] / f"{case}-{who}")
        cfg.RESUME = ""
        cfg.freeze()
        monkeypatch.setattr(fed, "cfg", cfg)
        monkeypatch.setattr(fed, "num_rounds", 1)
        monkeypatch.setattr(fed, "local_epochs", 1)
        fed.global_weights = (jax_fed if who == "jax" else port_fed).copy_tree(fed.initial)
        # the round-end test() is held by test_parallel_rounds_match_jax; here
        # it would only add the JAX eval's compile to a loop-rules check
        monkeypatch.setattr(fed.clients[0], "test", lambda *a, **k: {"accuracy": 0.0})
        c1 = fed.clients[1]
        if case == "unequal_clients_cycle":
            monkeypatch.setattr(c1, "train_loader_x", _Loader(c1.train_loader_x, 2))
        elif case == "zero_batch_client":
            monkeypatch.setattr(c1, "train_loader_x", _Loader(c1.train_loader_x, 0))
        elif case == "heterogeneous_batches":
            parse = type(c1).parse_batch_train
            monkeypatch.setattr(c1, "parse_batch_train",
                                lambda b, c1=c1, parse=parse: {**parse(c1, b), "extra": b["label"]})
        else:
            monkeypatch.setattr(fed, "num_clients", 3)
        try:
            seen[who + "_result"] = fed.train()
        except ValueError as e:
            seen[who + "_result"] = f"ValueError: {e}"
        seen[who + "_log"] = [line for line in capsys.readouterr().out.splitlines()
                              if line.startswith("[FED]")]
    assert seen["port_result"] == seen["jax_result"]
    assert seen["port_log"] == seen["jax_log"]
    assert seen["port"] == seen["jax"]
    if case == "unequal_clients_cycle":
        assert len(seen["port"]) == len(par["port"].clients[0].train_loader_x) > 2
        assert "[FED] client epoch lengths differ" in " ".join(seen["port_log"])
    elif case == "three_clients_fall_back":
        assert seen["port_result"] == "sequential"
        assert "falling back to sequential rounds" in " ".join(seen["port_log"])
    else:
        assert seen["port_result"].startswith("ValueError")


# -- the orbax decision --------------------------------------------------------------


def test_port_refuses_to_resume_from_jax_orbax_rounds(par, tmp_path, monkeypatch):
    """The JAX package, which has orbax here, writes ``round-1.orbax``; the
    port under ``TRAIN.CHECKPOINT_BACKEND orbax`` refuses to resume from it
    with the JAX package's message rather than restart from round 0."""
    from federated_multi_modal_tpu.engine.checkpoint_orbax import save_pytree

    save_pytree(str(tmp_path / AGG / "round-1.orbax"), par["jax"].global_weights)
    port = par["port"]
    cfg = port.cfg.clone()
    cfg.defrost()
    cfg.TRAIN.CHECKPOINT_BACKEND = "orbax"
    cfg.RESUME = str(tmp_path)
    cfg.freeze()
    monkeypatch.setattr(port, "cfg", cfg)
    with pytest.raises(RuntimeError, match="refusing to silently restart from round 0"):
        port._resume_round()


def test_jax_resumes_the_ports_orbax_fallback_round(par, tmp_path, capsys, monkeypatch):
    """The port under ``TRAIN.CHECKPOINT_BACKEND orbax`` writes its round in
    the pickle format with the JAX package's line; the JAX package under the
    same setting finds no orbax round and resumes from it."""
    port, ref = par["port"], par["jax"]
    for fed, out, resume in ((port, tmp_path / "port", ""), (ref, tmp_path / "jax", tmp_path / "port")):
        cfg = fed.cfg.clone()
        cfg.defrost()
        cfg.TRAIN.CHECKPOINT_BACKEND = "orbax"
        cfg.OUTPUT_DIR, cfg.RESUME = str(out), str(resume)
        cfg.freeze()
        monkeypatch.setattr(fed, "cfg", cfg)
    port.global_weights = port_fed.copy_tree(port.initial)
    port._save_round(0)
    assert "[FED] orbax-checkpoint unavailable; falling back to pickle" in capsys.readouterr().out
    assert os.path.isfile(tmp_path / "port" / AGG / "model.pth.tar-round1")
    ref.global_weights = jax_fed.copy_tree(ref.initial)
    assert ref._resume_round() == 1
    _assert_weights_close(_flat(ref.global_weights), _flat(port.global_weights), "orbax fallback")


# -- single-site data parallelism ------------------------------------------------------


def _coop_cfg(defaults, data_root, out, weights, dp, init=""):
    cfg = defaults()
    cfg.DATASET.ROOT = str(data_root)
    cfg.DATASET.NAME = "Synthetic"
    cfg.MODEL.BACKBONE.NAME = "Tiny"
    cfg.MODEL.BACKBONE.WEIGHTS_PATH = str(weights)
    cfg.MODEL.INIT_WEIGHTS = str(init)
    cfg.INPUT.SIZE = (32, 32)
    cfg.INPUT.CANVAS_SIZE = 40
    cfg.DATALOADER.TRAIN_X.BATCH_SIZE = 8
    cfg.DATALOADER.TEST.BATCH_SIZE = 8
    cfg.OPTIM.MAX_EPOCH = 1
    cfg.OPTIM.LR = 0.02
    cfg.TRAIN.PRINT_FREQ = 100
    cfg.TRAINER.NAME = "CoOp"
    cfg.TRAINER.COOP.PREC = "fp32"
    cfg.OUTPUT_DIR = str(out)
    cfg.SEED = 1
    cfg.VERBOSE = False
    cfg.TPU.DATA_PARALLEL = dp
    return cfg


def test_single_site_data_parallel_matches_jax(weights, tmp_path):
    """``TPU.DATA_PARALLEL`` CoOp over eight devices (a batch of eight, one
    image a device): two steps give the loss and ``ctx`` of JAX's
    data-parallel run, and of the port's own single-device run."""
    weights, data_root = weights
    rng = np.random.default_rng(3)
    images = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
    labels = (np.arange(8) % 4).astype(np.int32)
    ref = jax_build_trainer(_coop_cfg(jax_defaults, data_root, tmp_path / "jax", weights, True))
    init = tmp_path / "init" / "init.pth.tar"
    jax_save({"epoch": 0, "state_dict": jax_flatten(ref.trainable)}, str(init.parent),
             model_name=init.name)
    assert ref._dp_mesh is not None
    for _ in range(2):
        want = ref.train_step({"image": jnp.asarray(images), "label": jnp.asarray(labels)})
    want_ctx = np.asarray(ref.trainable["prompt_learner"]["ctx"])
    got = {}
    for dp in (True, False):
        port = build_trainer(_coop_cfg(get_cfg_default, data_root, tmp_path / f"port{dp}",
                                       weights, dp, init), device="cpu")
        assert (port._dp_devices == CPUS) if dp else port._dp_devices is None
        for _ in range(2):
            summary = port.train_step({"image": torch.from_numpy(images),
                                       "label": torch.from_numpy(labels)})
        got[dp] = (summary["loss"], port.trainable["prompt_learner"]["ctx"].numpy())
        assert port.model_inference(torch.from_numpy(images)).shape == (8, port.num_classes)
    for dp in (True, False):
        assert abs(got[dp][0] - want["loss"]) < DP_LOSS_ATOL, dp
        np.testing.assert_allclose(got[dp][1], want_ctx, atol=DP_CTX_ATOL, err_msg=str(dp))


# -- TPU.REMAT and TRAIN.PROFILE_DIR ------------------------------------------------


def test_remat_matches_jax(fed_step_inputs, monkeypatch):
    """MaPLe with ``remat``: the loss and every trainable gradient equal the
    port's without it, and JAX's ``build_maple_program(remat=True)``'s, at
    the whole step's limits (fp32); every block of both towers ran under
    ``torch.utils.checkpoint``."""
    prog, frozen, batch = fed_step_inputs["jax"]
    jb = {k: jnp.asarray(v[0]) for k, v in batch.items()}
    jprog = jax_flagship.build_maple_program(backbone="Tiny", depth=3, use_captions=False,
                                             remat=True)

    def wrapped(tr):
        return jprog["loss_fn"](tr, frozen, jb)[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(wrapped))(prog["trainable"])
    jgrads = {k: np.asarray(v, np.float32) for k, v in jax_flatten(jgrads).items()}
    _, trainable, pfrozen, pbatch = fed_step_inputs["port"]
    pb = {k: v[0] for k, v in pbatch.items()}
    calls = []
    checkpoint = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda fn, *a, **k: calls.append(fn) or checkpoint(fn, *a, **k))
    out = {}
    for remat in (False, True):
        pprog = port_flagship.build_maple_program(backbone="Tiny", depth=3, use_captions=False,
                                                  remat=remat, device="cpu")
        loss, grads, _ = loss_grads_and_aux(pprog["loss_fn"], trainable, pfrozen, pb)
        out[remat] = (float(loss), {k: v.numpy() for k, v in flatten(grads).items()})
    arch = port_params.BACKBONE_CONFIGS["Tiny"]
    assert len(calls) == arch.vision_layers + arch.transformer_layers
    assert out[True][0] == out[False][0]
    for k, v in out[False][1].items():
        np.testing.assert_array_equal(out[True][1][k], v, err_msg=k)
    assert abs(out[True][0] - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    for k, g in out[True][1].items():
        ref = jgrads[k]
        err = np.abs(g - ref).max() / max(np.abs(ref).max(), 1e-30)
        assert err < GRAD_TOL or not ref.any(), (k, err)


def test_maple_trainer_reads_remat_and_profile_dir(weights, tmp_path, monkeypatch):
    """A MaPLe trainer built with ``TPU.REMAT True`` and
    ``TRAIN.PROFILE_DIR``: its train step runs every block under
    ``torch.utils.checkpoint``, and an epoch writes a ``torch.profiler``
    trace into the directory, which holds the train step's span ranges
    (``utils/profiling.py``)."""
    cfg = _cfg(get_cfg_default, weights[1], tmp_path / "out", weights[0])
    cfg.TRAINER.NAME = "MaPLe"
    cfg.TPU.REMAT = True
    cfg.TRAIN.PROFILE_DIR = str(tmp_path / "trace")
    cfg.OPTIM.MAX_EPOCH = 1
    trainer = build_trainer(cfg, device="cpu")
    calls = []
    checkpoint = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda fn, *a, **k: calls.append(fn) or checkpoint(fn, *a, **k))
    trainer.run_epoch()
    arch = trainer.arch
    steps = len(trainer.train_loader_x)
    assert len(calls) == steps * (arch.vision_layers + arch.transformer_layers) > 0
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert traces
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    want = {"forward_backward", "prompt_learner", "text_tower", "vision_tower", "loss",
            "backward", "update", "prompt_learner.backward", "text_tower.backward",
            "vision_tower.backward", "loss.backward"}
    assert want <= names, want - names


def test_run_replicas_over_a_device_named_twice():
    """``run_replicas`` over a device named twice (two CPU replicas): each
    replica's work gets its input as given, on its device (no copy), and the
    outputs come back in replica order on the home device; ``replicate`` on
    the same device returns each tensor itself, and ``mean_over_devices``
    sums in list order into new tensors, then divides."""
    cpu = torch.device("cpu")
    x = torch.arange(4.0)
    seen = []

    def work(device, inputs):
        seen.append((device, inputs))
        return {"y": inputs * 2 + len(seen)}

    outs = port_mesh.run_replicas(work, [cpu, cpu], [x, x + 1], cpu)
    assert seen[0][1] is x and [d for d, _ in seen] == [cpu, cpu]
    assert [o["y"].tolist() for o in outs] == [[1.0, 3.0, 5.0, 7.0], [4.0, 6.0, 8.0, 10.0]]
    frozen = {"w": torch.ones(3)}
    assert port_mesh.replicate(frozen, cpu)["w"] is frozen["w"]
    one = port_mesh.mean_over_devices([x], cpu)
    assert one is not x and torch.equal(one, x)
    a, b, c = torch.tensor([1e8]), torch.tensor([1.0]), torch.tensor([-1e8])
    assert float(port_mesh.mean_over_devices([a, b, c], cpu)) == float((a + b + c) / 3)


# -- the order in which the replicas are issued on CUDA streams --------------------

# kind: "replay" (a graph), "work" (an eager replica's or the home's work), "copy"
# or "wait"; owner: a replica's index or "home" (None for a wait); stream: where
# it runs (for a wait, the stream that waits); waited: the stream waited for
Op = collections.namedtuple("Op", "kind owner stream round waited")


class _Issue:
    """Stand-ins for CUDA streams, graphs and copies between cards that
    record every operation in the order the host issues it, and for each the
    operations it is ordered after. A stream holds what was issued to it and
    what it waited for. A copy between cards runs as PyTorch's does: on the
    source card's current stream, after that stream waited for the
    destination card's current stream, which then waits for the copy. As
    in PyTorch, making a stream current makes its card the current one."""

    def __init__(self, monkeypatch):
        self.ops, self.after, self.current, self.round = [], {}, {}, 0
        self.card = 0
        issue = self

        class Stream:
            def __init__(self, device):
                self.device, self.before = torch.device(device), set()

            def wait_stream(self, other):
                issue.ops.append(Op("wait", None, self, issue.round, other))
                self.before |= other.before

        @contextlib.contextmanager
        def stream(s):
            prev, card = self.stream_of(s.device), self.card
            self.current[s.device.index], self.card = s, s.device.index
            try:
                yield
            finally:
                self.current[s.device.index], self.card = prev, card

        self.Stream = Stream
        monkeypatch.setattr(port_mesh, "_STREAMS", {})
        monkeypatch.setattr(torch.cuda, "Stream", Stream)
        monkeypatch.setattr(torch.cuda, "stream", stream)
        monkeypatch.setattr(torch.cuda, "current_stream", self.stream_of)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: self.card)
        monkeypatch.setattr(port_mesh, "_copy", self.copy)
        monkeypatch.setattr(torch, "empty_like", lambda t, device: self.tensor(t.owner, device))

    def stream_of(self, device):
        index = torch.device(device).index
        index = self.card if index is None else index
        if index not in self.current:
            self.current[index] = self.Stream(torch.device("cuda", index))
        return self.current[index]

    def run(self, kind, owner, stream):
        self.after[len(self.ops)] = frozenset(stream.before)
        stream.before.add(len(self.ops))
        self.ops.append(Op(kind, owner, stream, self.round, None))

    def copy(self, dst, src):
        stream, far = self.stream_of(src.device), self.stream_of(dst.device)
        stream.wait_stream(far)
        self.run("copy", src.owner, stream)
        far.wait_stream(stream)

    def tensor(self, owner, device):
        return types.SimpleNamespace(owner=owner, device=torch.device(device))

    def graph(self, owner, device):
        return types.SimpleNamespace(
            replay=lambda: self.run("replay", owner, self.stream_of(device)))

    def faults(self, home_stream) -> list:
        """What, in each recorded round (home work, the replicas, home
        work), breaks the order the replicas must be issued in."""
        out = []
        for r in range(self.round + 1):
            runs = [(i, op) for i, op in enumerate(self.ops) if op.round == r and op.kind != "wait"]
            replica = [(i, op) for i, op in runs if op.owner != "home"]
            graphs = {op.owner: i for i, op in replica if op.kind != "copy"}
            waited = [i for i, op in enumerate(self.ops) if op.round == r and op.kind == "wait"
                      and op.stream is home_stream and op.waited is not home_stream]
            for j, i in graphs.items():
                if waited and i > waited[0]:
                    out.append(f"round {r}: replica {j} issued after the home stream waited")
                if any(k in self.after[i] and op.owner != j for k, op in replica):
                    out.append(f"round {r}: replica {j} waits for another replica")
            out += [f"round {r}: replica {op.owner} copies on the home stream"
                    for _, op in replica if op.kind == "copy" and op.stream is home_stream]
            last_home = [i for i, op in runs if op.owner == "home"][-1]
            if not {i for i, _ in replica} <= self.after[last_home]:
                out.append(f"round {r}: the home work after the replicas does not wait for them")
            if r:
                prev = [(i, op) for i, op in enumerate(self.ops)
                        if op.round == r - 1 and op.kind != "wait"]
                prev_home = [i for i, op in prev if op.owner == "home"][-1]
                prev_graph = {op.owner: i for i, op in prev if op.kind != "copy"}
                out += [f"round {r}: replica {op.owner}'s copy may overtake round {r - 1}"
                        for i, op in replica if op.kind == "copy"
                        and not {prev_home, prev_graph[op.owner]} <= self.after[i]]
        return out


ISSUE_CASES = {
    # id: (the cards of the replicas, home on card 0; the planted fault)
    "far_cards": ([0, 1, 2, 3], False),
    "card_named_twice": ([0, 0], False),
    "far_cards_planted_fault": ([0, 1, 2, 3], True),
}


@pytest.mark.parametrize("path", ["replay", "eager"])
@pytest.mark.parametrize("case", list(ISSUE_CASES))
def test_replicas_are_issued_before_the_home_stream_waits(case, path, monkeypatch):
    """Two rounds of home work, the replicas, home work, through
    ``StepGraph.replay`` (a hand-built program: a far replica copies two
    leaves each way) and through ``run_replicas`` on CUDA, with stand-in
    streams, graphs and copies: every replica's graph or work is issued
    before the home stream first waits for a replica; no replica is ordered
    after another's work or copies, directly or through the home stream; no
    copy runs on the home stream; the home work after the replicas waits for
    all of them; and each copy of the second round waits for its replica's
    graph and the home work of the first. ``run_replicas`` is given its
    home as ``cuda`` (the current card, which a replica's stream changes)
    and returns every output on card 0. Where nothing crosses cards (a
    card named twice) there is no copy and no side stream. The planted fault
    gives the copies the home stream as their side stream, which is the
    order that issued the replicas one after another: the faults are
    found, and the counter reads the two replicas issued before the home
    stream waited."""
    cards, planted = ISSUE_CASES[case]
    issue = _Issue(monkeypatch)
    home = torch.device("cuda", 0)
    devices = [torch.device("cuda", c) for c in cards]
    far = [j for j, d in enumerate(devices) if d != home]
    home_stream = torch.cuda.current_stream(home)
    phases = []

    class Phase(port_mesh.ReplicaPhase):
        def __init__(self, home):
            super().__init__(home)
            phases.append(self)

    monkeypatch.setattr(port_mesh, "ReplicaPhase", Phase)
    if planted:
        monkeypatch.setattr(port_mesh, "copy_stream",
                            lambda j, home: torch.cuda.current_stream(home))
    if path == "replay":
        graph = port_mesh.StepGraph(home)

        def leaves(j, d):
            return [issue.tensor(j, d) for _ in range(2 if j in far else 0)]

        graph.program = [("home", issue.graph("home", home)),
                         ("replicas", [(d, list(zip(leaves(j, home), leaves(j, d))),
                                        issue.graph(j, d), list(zip(leaves(j, d), leaves(j, home))))
                                       for j, d in enumerate(devices)]),
                         ("home", issue.graph("home", home))]
        step = graph.replay
    else:
        def work(d, x):
            issue.run("work", x[0].owner, torch.cuda.current_stream(d))
            return [issue.tensor(x[0].owner, d), issue.tensor(x[0].owner, d)]

        def step():
            issue.run("work", "home", home_stream)
            outs = port_mesh.run_replicas(work, devices, [[issue.tensor(j, home)] * 2
                                                          for j in range(len(devices))],
                                          torch.device("cuda"))
            assert {t.device for out in outs for t in out} == {home}
            issue.run("work", "home", home_stream)

    for issue.round in range(2):
        step()
    counted = graph if path == "replay" else phases[-1]
    faults = issue.faults(home_stream)
    side = sorted(k[0][1] for k in port_mesh._STREAMS if isinstance(k[0], tuple))
    if planted:
        assert any("issued after the home stream waited" in f for f in faults), faults
        assert any("waits for another replica" in f for f in faults), faults
        assert any("copies on the home stream" in f for f in faults), faults
        assert counted.in_flight == 2
        return
    assert faults == []
    assert (counted.in_flight, counted.copies) == (len(devices), 4 * len(far))
    assert side == far
    assert (not far) == (not any(op.kind == "copy" for op in issue.ops))


LOCAL_LAUNCHES = {
    # id: (processes, process id, LOCAL_WORLD_SIZE, LOCAL_RANK, the cards it drives)
    "alone": (1, 0, None, None, [0, 1, 2, 3]),
    "one_process_a_card": (4, 2, None, None, [2]),
    "one_process_a_card_local_rank": (8, 5, None, "1", [1]),
    "one_process_a_host": (2, 1, "1", "0", [0, 1, 2, 3]),
    "two_processes": (2, 1, "2", "1", [2, 3]),
    "two_processes_without_local_rank": (4, 3, "2", None, [2, 3]),
    "one_card_each": (4, 3, "4", "3", [3]),
    "more_processes": (8, 5, "8", "5", [1]),
}


def _launch(monkeypatch, local_world, local_rank):
    """Four visible cards, and the launcher's ``LOCAL_WORLD_SIZE`` and
    ``LOCAL_RANK`` as given (``None``: not set)."""
    cards = [torch.device("cuda", i) for i in range(4)]
    monkeypatch.setattr(port_mesh, "visible_devices", lambda device=None: list(cards))
    for name, value in (("LOCAL_WORLD_SIZE", local_world), ("LOCAL_RANK", local_rank)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    return cards


@pytest.mark.parametrize("launch", list(LOCAL_LAUNCHES))
def test_local_devices_share_the_cards(launch, monkeypatch):
    """A process alone drives every visible card. Of several processes,
    without ``torchrun``'s ``LOCAL_WORLD_SIZE`` each drives one card, the
    ``LOCAL_RANK``-th or else its process id modulo the cards (the launch
    by the JAX package's variables, one process a card); under it, its
    ``LOCAL_RANK``-th (else process id modulo ``LOCAL_WORLD_SIZE``) even
    share of them, every card at one process a host, the card
    ``LOCAL_RANK`` modulo their count where there are fewer cards than
    processes."""
    n, pid, local_world, local_rank, want = LOCAL_LAUNCHES[launch]
    cards = _launch(monkeypatch, local_world, local_rank)
    assert port_mesh.local_devices("cuda", pid, n) == [cards[i] for i in want]


@pytest.mark.parametrize("launch", ["one_process_a_card", "two_processes_without_local_rank",
                                    "more_processes"])
def test_initialize_multihost_sets_the_first_local_card(launch, monkeypatch):
    """``initialize_multihost`` makes current the first card that
    ``local_devices`` gives the process, before it starts the process group
    (here a start that fails, so that no group is left behind)."""
    from federated_multi_modal_tpu_torch.parallel import multihost

    n, pid, local_world, local_rank, want = LOCAL_LAUNCHES[launch]
    cards = _launch(monkeypatch, local_world, local_rank)
    current = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    with pytest.raises(RuntimeError, match="init_process_group failed"):
        multihost.initialize_multihost("bogus://nowhere", n, pid, backend="gloo")
    assert current == [cards[want[0]]]
    assert not torch.distributed.is_initialized()
