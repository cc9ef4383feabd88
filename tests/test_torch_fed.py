"""The port's ``MaPLeFederated`` against the JAX package's, on the CPU, on
two Synthetic clients and the Tiny backbone in fp32: the rounds end to end
(every round checkpoint, the final aggregator checkpoint, the per-epoch
per-client losses, every ``test()``'s accuracy, ``nan_stats``), each
package resuming from the other's round checkpoint, the validity gates and
the per-client failure isolation, the ``FED.PARALLEL_CLIENTS`` and
checkpoint-backend settings, and both packages' command lines.

Both packages start from the same weights: ``MODEL.BACKBONE.WEIGHTS_PATH``,
a Tiny CLIP in OpenAI's layout, and the JAX trainer's initial trainable
tree, which the port loads through ``MODEL.INIT_WEIGHTS``. Client 1's loader
draws from another seed than client 0's, so the clients diverge.

A trainer of each package is built once per module and run again for each
case: :func:`run` puts back the global weights, the accounting and the
loaders' generators as a fresh build has them (the JAX trainer keeps its
compiled steps, which is most of its cost).
"""

import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import federated_multi_modal_tpu.trainers  # noqa: F401 - registers the trainers
import federated_multi_modal_tpu_torch.trainers  # noqa: F401
from federated_multi_modal_tpu.config import get_cfg_default as jax_defaults
from federated_multi_modal_tpu.engine import build_trainer as jax_build_trainer
from federated_multi_modal_tpu.engine.checkpoint import flatten_params as jax_flatten
from federated_multi_modal_tpu.engine.checkpoint import load_checkpoint as jax_load
from federated_multi_modal_tpu.engine.checkpoint import save_checkpoint as jax_save
from federated_multi_modal_tpu.models import clip_model as jax_clip
from federated_multi_modal_tpu.ops import primitives as jax_prim
from federated_multi_modal_tpu.trainers import maple_fed as jax_fed
from federated_multi_modal_tpu_torch.config import get_cfg_default
from federated_multi_modal_tpu_torch.engine import build_trainer
from federated_multi_modal_tpu_torch.engine.checkpoint import flatten_params, load_checkpoint
from federated_multi_modal_tpu_torch.models import clip_model as port_clip
from federated_multi_modal_tpu_torch.models import params as port_params
from federated_multi_modal_tpu_torch.ops import primitives as port_prim
from federated_multi_modal_tpu_torch.trainers import maple_fed as port_fed

ROOT = Path(__file__).resolve().parents[1]
AGG = "MultiModalPromptLearner_Aggregator"
ROUNDS, LOCAL_EPOCHS = 2, 2
LOADER_SEEDS = (1, 99)  # client 0 keeps the loader's own seed (cfg.SEED 1)
# fp32 on both sides, the same arithmetic in another order: after the two
# rounds the global weights read at most 2.4e-7 apart and the per-epoch
# losses 4.4e-7 relative; the limits leave a margin of over 20x
WEIGHT_ATOL, WEIGHT_RTOL = 1e-5, 1e-4
LOSS_RTOL = 1e-5
MODULE_GLOBALS = ((jax_prim, "_ATTENTION_IMPL"), (jax_prim, "_VISION_ATTN_WGRAD_BLOCKS"),
                  (jax_clip, "_TEXT_PACK_DEFAULT"), (port_prim, "_ATTENTION_IMPL"),
                  (port_clip, "_TEXT_PACK_DEFAULT"))


@pytest.fixture(autouse=True)
def _module_globals(monkeypatch):
    """Each trainer sets its package's routing globals; put them back."""
    for module, attr in MODULE_GLOBALS:
        monkeypatch.setattr(module, attr, getattr(module, attr))


def _cfg(defaults, data_root, out, weights, init=""):
    cfg = defaults()
    cfg.DATASET.ROOT = str(data_root)
    cfg.DATASET.NAME = "Synthetic"
    cfg.MODEL.BACKBONE.NAME = "Tiny"
    cfg.MODEL.BACKBONE.WEIGHTS_PATH = str(weights)
    cfg.MODEL.INIT_WEIGHTS = str(init)
    cfg.INPUT.SIZE = (32, 32)
    cfg.INPUT.CANVAS_SIZE = 40
    cfg.DATALOADER.TRAIN_X.BATCH_SIZE = 4
    cfg.DATALOADER.TEST.BATCH_SIZE = 16
    cfg.OPTIM.NAME = "sgd"
    cfg.OPTIM.LR = 0.02
    cfg.OPTIM.MOMENTUM = 0.9
    cfg.OPTIM.WEIGHT_DECAY = 5e-4
    cfg.OPTIM.LR_SCHEDULER = "cosine"
    cfg.OPTIM.WARMUP_EPOCH = 1
    cfg.OPTIM.WARMUP_TYPE = "constant"
    cfg.OPTIM.WARMUP_CONS_LR = 5e-3
    cfg.OPTIM.MAX_EPOCH = ROUNDS * LOCAL_EPOCHS
    cfg.TRAIN.PRINT_FREQ = 3  # one drain inside each 4-step epoch, one at its end
    cfg.TRAINER.NAME = "MaPLeFederated"
    cfg.TRAINER.MAPLE.PROMPT_DEPTH = 3
    cfg.TRAINER.MAPLE.PREC = "fp32"
    cfg.OUTPUT_DIR = str(out)
    cfg.SEED = 1
    cfg.VERBOSE = False
    cfg.FED.NUM_CLIENTS = 2
    cfg.FED.NUM_ROUNDS = ROUNDS
    cfg.FED.LOCAL_EPOCHS = LOCAL_EPOCHS
    cfg.FED.DATASETS = ("Synthetic", "Synthetic")
    cfg.FED.CLASSNAME_ONLY_DATASETS = ()
    cfg.FED.CHECKPOINT_EVERY_ROUND = True
    cfg.TPU.DATA_PARALLEL = False
    return cfg


def _flat(tree):
    """The tree as the checkpoints name it, as fp32 numpy."""
    if isinstance(jax.tree_util.tree_leaves(tree)[0], torch.Tensor):
        return {k: np.asarray(v, np.float32) for k, v in flatten_params(tree).items()}
    return {k: np.asarray(v, np.float32) for k, v in jax_flatten(tree).items()}


def _is_jax(fed):
    return type(fed) is jax_fed.MaPLeFederated


def _poisoned(fed, client):
    """``client``'s trainable tree with ``ctx[0, 0]`` set to NaN."""
    tr = fed.clients[client].trainable
    ctx = tr["prompt_learner"]["ctx"]
    if _is_jax(fed):
        bad = np.asarray(ctx, np.float32).copy()
        bad[0, 0] = np.nan
        tr["prompt_learner"]["ctx"] = jnp.asarray(bad)
    else:
        bad = ctx.clone()
        bad[0, 0] = float("nan")
        tr["prompt_learner"]["ctx"] = bad


def run(fed, out, resume="", poison=None, fail=(), rounds=ROUNDS, local_epochs=LOCAL_EPOCHS):
    """``fed.train()`` from the initial weights into ``out``, recording
    each client's per-epoch loss and each ``test()``'s accuracy.

    ``poison=(client, epoch)`` writes a NaN into that client's weights after
    that epoch; ``fail`` holds ``(client, epoch, exception)``: that epoch
    raises the exception before the client touches its loader (so its
    generator's state stays that of a completed epoch in both packages)."""
    cfg = fed.cfg.clone()
    cfg.defrost()
    cfg.OUTPUT_DIR = str(out)
    cfg.RESUME = str(resume)
    cfg.freeze()
    fed.cfg = cfg
    fed.num_rounds, fed.local_epochs = rounds, local_epochs
    fed.global_weights = (jax_fed if _is_jax(fed) else port_fed).copy_tree(fed.initial)
    fed.nan_stats = {"total_updates": 0, "failed_clients": [], "skipped_rounds": 0}
    record = {"losses": [], "tests": []}
    for i, client in enumerate(fed.clients):
        client.train_loader_x.rng = np.random.default_rng(LOADER_SEEDS[i])
        client.train_loader_x._plan = None

        def run_epoch(epoch=None, i=i, client=client, cls_run=type(client).run_epoch):
            for c, e, exc in fail:
                if (c, e) == (i, epoch):
                    raise exc
            res = cls_run(client, epoch)
            record["losses"].append((i, epoch, res["avg_loss"]))
            if poison == (i, epoch):
                _poisoned(fed, i)
            return res

        def test(split=None, i=i, client=client, cls_test=type(client).test):
            res = cls_test(client, split)
            record["tests"].append((i, res["accuracy"]))
            return res

        client.run_epoch, client.test = run_epoch, test
    try:
        fed.train()
    finally:
        for client in fed.clients:
            del client.run_epoch, client.test
    record["stats"] = {k: (list(v) if isinstance(v, list) else v)
                       for k, v in fed.nan_stats.items()}
    record["final"] = _flat(fed.global_weights)
    return record


def _checkpoints(out):
    return {p.name: load_checkpoint(str(p)) for p in sorted((Path(out) / AGG).glob("model.*"))}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    d = tmp_path_factory.mktemp("weights")
    arch = port_params.BACKBONE_CONFIGS["Tiny"]
    tree = port_params.init_clip_params(arch, torch.Generator().manual_seed(11),
                                        dtype_policy=False)
    path = d / "tiny_openai.pt"
    torch.save(port_params.export_openai_state_dict(tree, arch), path)
    return path


@pytest.fixture(scope="module")
def feds(tmp_path_factory, weights):
    """A trainer of each package on the same weights, and each one's run of
    ``ROUNDS`` rounds of ``LOCAL_EPOCHS`` local epochs."""
    d = tmp_path_factory.mktemp("fed")
    data_root = d / "data"
    with pytest.MonkeyPatch.context() as mp:
        for module, attr in MODULE_GLOBALS:
            mp.setattr(module, attr, getattr(module, attr))
        ref = jax_build_trainer(_cfg(jax_defaults, data_root, d / "jax-build", weights))
        init = d / "init" / "init.pth.tar"
        jax_save({"epoch": 0, "state_dict": jax_flatten(ref.global_weights)},
                 str(init.parent), model_name=init.name)
        port = build_trainer(_cfg(get_cfg_default, data_root, d / "port-build", weights, init),
                             device="cpu")
    for fed in (ref, port):
        fed.initial = (jax_fed if _is_jax(fed) else port_fed).copy_tree(fed.global_weights)
    with pytest.MonkeyPatch.context() as mp:
        for module, attr in MODULE_GLOBALS:
            mp.setattr(module, attr, getattr(module, attr))
        runs = {"jax": run(ref, d / "jax"), "port": run(port, d / "port")}
    return {"dir": d, "jax": ref, "port": port, "runs": runs, "data_root": data_root,
            "init": init}


def _assert_weights_close(got: dict, want: dict, what: str):
    assert got.keys() == want.keys(), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=WEIGHT_RTOL, atol=WEIGHT_ATOL,
                                   err_msg=f"{what}: {k}")


def _assert_runs_agree(got, want, what):
    assert got["stats"] == want["stats"], what
    assert [(c, e) for c, e, _ in got["losses"]] == [(c, e) for c, e, _ in want["losses"]]
    np.testing.assert_allclose([x for _, _, x in got["losses"]],
                               [x for _, _, x in want["losses"]], rtol=LOSS_RTOL, err_msg=what)
    assert got["tests"] == want["tests"], what
    _assert_weights_close(got["final"], want["final"], what)


def test_rounds_match_jax(feds):
    """Both clients' per-epoch losses, every ``test()``'s accuracy (each
    local epoch's and each round's on client 0), ``nan_stats``, every round
    checkpoint and the final aggregator checkpoint (its class-conditioned
    constants too) agree; the clients diverge, and the initial weights
    were the same."""
    got, want = feds["runs"]["port"], feds["runs"]["jax"]
    _assert_weights_close(_flat(feds["port"].initial), _flat(feds["jax"].initial), "initial")
    assert want["stats"] == {"total_updates": ROUNDS, "failed_clients": [], "skipped_rounds": 0}
    assert len(want["losses"]) == 2 * ROUNDS * LOCAL_EPOCHS
    losses = {(c, e): x for c, e, x in want["losses"]}
    assert losses[(0, 0)] != losses[(1, 0)]
    _assert_runs_agree(got, want, "end to end")
    ckpt_got = _checkpoints(feds["dir"] / "port")
    ckpt_want = _checkpoints(feds["dir"] / "jax")
    names = [f"model.pth.tar-round{r + 1}" for r in range(ROUNDS)] + [
        f"model.pth.tar-{ROUNDS * LOCAL_EPOCHS}"]
    assert sorted(ckpt_got) == sorted(ckpt_want) == sorted(names)
    for name in names:
        g, w = ckpt_got[name], ckpt_want[name]
        assert g["epoch"] == w["epoch"] and g["optimizer"] is w["optimizer"] is None, name
        _assert_weights_close({k: np.asarray(v, np.float32) for k, v in g["state_dict"].items()},
                              {k: np.asarray(v, np.float32) for k, v in w["state_dict"].items()},
                              name)
    final = ckpt_got[names[-1]]["state_dict"]
    assert {"prompt_learner.token_prefix", "prompt_learner.token_suffix"} <= set(final)
    # the round checkpoint read back by the other package
    round2 = jax_load(str(feds["dir"] / "port" / AGG / names[1]))["state_dict"]
    _assert_weights_close({k: np.asarray(v, np.float32) for k, v in round2.items()},
                          want["final"], "the port's round 2 read by the JAX package")


def test_clients_share_one_frozen_tower(feds):
    """The frozen CLIP leaves are the same storage in both clients, the
    trainable leaves are not, and nothing frozen requires a gradient."""
    from federated_multi_modal_tpu_torch.engine.tree import flatten

    a, b = (flatten(c.frozen["model"]) for c in feds["port"].clients)
    assert a.keys() == b.keys() and len(a) > 10
    assert all(a[k].data_ptr() == b[k].data_ptr() for k in a)
    assert not any(t.requires_grad for t in a.values())
    ta, tb = (flatten(c.trainable) for c in feds["port"].clients)
    assert not {t.data_ptr() for t in ta.values()} & {t.data_ptr() for t in tb.values()}


def test_resume_from_the_other_packages_round(feds, tmp_path):
    """Each package resumes (``RESUME``) from the other's round-1
    checkpoint and trains round 2 to the same weights."""
    srcs = {}
    for who in ("jax", "port"):
        srcs[who] = tmp_path / f"{who}-round1" / AGG
        srcs[who].mkdir(parents=True)
        shutil.copy(feds["dir"] / who / AGG / "model.pth.tar-round1", srcs[who])
    got = run(feds["port"], tmp_path / "port-resumed", resume=srcs["jax"].parent)
    want = run(feds["jax"], tmp_path / "jax-resumed", resume=srcs["port"].parent)
    assert [e for _, e, _ in want["losses"]] == [2, 3, 2, 3]
    assert want["stats"]["total_updates"] == 1
    _assert_runs_agree(got, want, "resumed")


GATE_CASES = {
    # client 1's weights poisoned after its epoch of round 0: it is reset to
    # the global weights and left out, nothing counts as failed
    "poisoned": dict(poison=(1, 0)),
    # client 1's first epoch raises RuntimeError: counted failed, left out
    "client_fails": dict(fail=[(1, 0, RuntimeError("planted"))]),
    # every client's first epoch raises: the round is skipped, the global
    # weights stay, round 2 trains
    "all_fail": dict(fail=[(0, 0, RuntimeError("planted")), (1, 0, RuntimeError("planted"))]),
}
GATE_STATS = {
    "poisoned": {"total_updates": 2, "failed_clients": [], "skipped_rounds": 0},
    "client_fails": {"total_updates": 2, "failed_clients": [1], "skipped_rounds": 0},
    "all_fail": {"total_updates": 1, "failed_clients": [0, 1], "skipped_rounds": 1},
}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_gates_match_jax(case, feds, tmp_path, capsys):
    """The validity gate and the failure isolation give the same global
    weights, losses, accuracies and accounting in both packages (one local
    epoch a round)."""
    kwargs = dict(GATE_CASES[case], local_epochs=1)
    want = run(feds["jax"], tmp_path / "jax", **kwargs)
    jax_log = capsys.readouterr().out
    got = run(feds["port"], tmp_path / "port", **kwargs)
    port_log = capsys.readouterr().out
    assert want["stats"] == GATE_STATS[case]
    _assert_runs_agree(got, want, case)
    for line in ("Client 1 produced invalid weights, skipping aggregation",
                 "Client 1 failed training: planted",
                 "All clients failed! Reverting to previous global model."):
        assert (line in port_log) == (line in jax_log), line


def test_a_non_runtime_error_propagates(feds, tmp_path):
    """Only ``RuntimeError`` counts as a failed client: anything else ends
    the run in both packages."""
    for fed in (feds["jax"], feds["port"]):
        with pytest.raises(ValueError, match="planted"):
            run(fed, tmp_path / type(fed).__module__, fail=[(0, 0, ValueError("planted"))],
                rounds=1, local_epochs=1)
        assert fed.nan_stats["failed_clients"] == []


@pytest.mark.parametrize("n_dev,clients", [(1, 2), (8, 3), (8, 2), (1, 1), (4, 4)])
def test_parallel_clients_setting(n_dev, clients, feds, monkeypatch, capsys):
    """``FED.PARALLEL_CLIENTS`` over ``n_dev`` devices: both packages take
    their parallel round loop where the devices tile the clients and
    otherwise print the same line and run the sequential rounds."""
    from federated_multi_modal_tpu_torch.parallel import mesh

    choices = []
    for fed in (feds["jax"], feds["port"]):
        cfg = fed.cfg.clone()
        cfg.defrost()
        cfg.FED.PARALLEL_CLIENTS = True
        cfg.FED.NUM_CLIENTS = clients
        cfg.freeze()
        monkeypatch.setattr(fed, "cfg", cfg)
        monkeypatch.setattr(fed, "num_clients", clients)
        monkeypatch.setattr(fed, "_train_sequential", lambda: "sequential")
        monkeypatch.setattr(fed, "_train_parallel", lambda: "parallel")
    monkeypatch.setattr(jax, "device_count", lambda: n_dev)
    monkeypatch.setattr(mesh, "visible_devices", lambda device=None: [torch.device("cpu")] * n_dev)
    jax_choice = feds["jax"].train()
    jax_log = capsys.readouterr().out
    port_choice = feds["port"].train()
    assert port_choice == jax_choice
    assert capsys.readouterr().out == jax_log
    assert ("falling back to sequential rounds" in jax_log) == (jax_choice == "sequential")


def test_orbax_backend_and_multiprocess_refused(feds, monkeypatch, tmp_path):
    """Under ``TRAIN.CHECKPOINT_BACKEND orbax`` the port, which has no
    orbax, refuses to resume from orbax round directories (rather than
    restart from round 0); ``MaPLeFederated.train()`` refuses to run under
    several processes."""
    (tmp_path / AGG / "round-1.orbax").mkdir(parents=True)
    cfg = feds["port"].cfg.clone()
    cfg.defrost()
    cfg.TRAIN.CHECKPOINT_BACKEND = "orbax"
    cfg.RESUME = str(tmp_path)
    cfg.freeze()
    monkeypatch.setattr(feds["port"], "cfg", cfg)
    with pytest.raises(RuntimeError, match="refusing to silently restart from round 0"):
        feds["port"]._resume_round()
    monkeypatch.setattr(port_fed, "process_count", lambda: 2)
    with pytest.raises(RuntimeError, match="single-process"):
        feds["port"].train()


# -- the command line -----------------------------------------------------------

sys.path.insert(0, str(ROOT))  # the repository's train.py
import train as jax_cli  # noqa: E402
from federated_multi_modal_tpu_torch import train as port_cli  # noqa: E402


def _jax_parser():
    """``train.py``'s parser, which it builds inline under ``__main__``."""
    source = (ROOT / "train.py").read_text()
    body = source.split('if __name__ == "__main__":\n', 1)[1]
    body = body.replace("    main(parser.parse_args())", "    return parser")
    namespace = {"argparse": __import__("argparse")}
    exec("def build_parser():\n" + body, namespace)
    return namespace["build_parser"]()

FED_YAML = "configs/trainers/MaPLeFederated/vit_b16_c2_ep5_batch4_2ctx_cross_datasets.yaml"


def _argv(out, data_root, weights, init, extra=()):
    return ["--root", str(data_root), "--seed", "1", "--trainer", "MaPLeFederated",
            "--dataset-config-file", str(ROOT / "configs/datasets/synthetic.yaml"),
            "--config-file", str(ROOT / FED_YAML), "--output-dir", str(out), *extra,
            "MODEL.BACKBONE.NAME", "Tiny", "INPUT.SIZE", "(32, 32)", "INPUT.CANVAS_SIZE", "40",
            "TRAINER.MAPLE.PROMPT_DEPTH", "3", "TRAINER.MAPLE.PREC", "fp32",
            "FED.NUM_ROUNDS", "1", "FED.LOCAL_EPOCHS", "1",
            "FED.DATASETS", "('Synthetic', 'Synthetic')", "FED.CLASSNAME_ONLY_DATASETS", "()",
            "DATALOADER.TEST.BATCH_SIZE", "16", "TPU.DATA_PARALLEL", "False", "VERBOSE", "False",
            "MODEL.BACKBONE.WEIGHTS_PATH", str(weights), "MODEL.INIT_WEIGHTS", str(init)]


def _main(cli, parser, argv, env=None):
    """``cli.main`` in process: each client's ``test()`` accuracies, in
    order, and the trainer (the port's ``main`` returns it)."""
    from federated_multi_modal_tpu.engine.registry import TRAINER_REGISTRY as JAX_TRAINERS
    from federated_multi_modal_tpu_torch.engine.registry import TRAINER_REGISTRY

    record = {"tests": []}
    maple = (JAX_TRAINERS if cli is jax_cli else TRAINER_REGISTRY).get("MaPLe")
    test = maple.test

    def recorded(self, *args, **kwargs):
        result = test(self, *args, **kwargs)
        record["tests"].append(result)
        return result

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "stdout", sys.stdout)
        for module, attr in MODULE_GLOBALS:
            mp.setattr(module, attr, getattr(module, attr))
        for key, value in (env or {}).items():
            mp.setenv(key, value)
        mp.setattr(maple, "test", recorded)
        record["trainer"] = cli.main(parser.parse_args(argv))
    return record


def test_command_line_matches_jax(feds, tmp_path):
    """``--trainer MaPLeFederated`` through each package's ``main`` on the
    federated configuration (one round of one local epoch): the same
    accuracies, the aggregator checkpoint at
    ``MultiModalPromptLearner_Aggregator/model.pth.tar-<MAX_EPOCH>``, and
    ``--eval-only --model-dir`` reloading the port's checkpoint and the JAX
    package's to their runs' final accuracy."""
    args = (feds["data_root"], feds["port"].cfg.MODEL.BACKBONE.WEIGHTS_PATH, feds["init"])
    cpu = {"FMM_TPU_PLATFORM": "cpu"}
    want = _main(jax_cli, _jax_parser(), _argv(tmp_path / "jax", *args))
    got = _main(port_cli, port_cli.build_parser(), _argv(tmp_path / "port", *args), cpu)
    accuracies = [r["accuracy"] for r in got["tests"]]
    assert accuracies == [r["accuracy"] for r in want["tests"]] and accuracies
    max_epoch = got["trainer"].cfg.OPTIM.MAX_EPOCH
    for who in ("jax", "port"):
        assert (tmp_path / who / AGG / f"model.pth.tar-{max_epoch}").is_file()
        reload = _main(port_cli, port_cli.build_parser(),
                       _argv(tmp_path / f"eval-{who}", *args,
                             extra=("--eval-only", "--model-dir", str(tmp_path / who))), cpu)
        assert [r["accuracy"] for r in reload["tests"]] == accuracies[-1:]
    assert "Finished training" in (tmp_path / "port" / "log.txt").read_text()
