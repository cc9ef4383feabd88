"""The port's trainer engine (``federated_multi_modal_tpu_torch/engine``)
against the JAX package's: the LR schedule, the optimizers over ten steps
with the LR changed between them, the evaluator's lines and result, and
checkpoints written by one package and read by the other."""

import io
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import federated_multi_modal_tpu.models.clip_model as jax_clip
import federated_multi_modal_tpu.ops.primitives as jax_prim
import federated_multi_modal_tpu.trainers  # noqa: F401 - registers the trainers
from federated_multi_modal_tpu.config import get_cfg_default as jax_defaults
from federated_multi_modal_tpu.engine import build_trainer as jax_build_trainer
from federated_multi_modal_tpu.engine import checkpoint as jax_ckpt
from federated_multi_modal_tpu.engine import optim as jax_optim
from federated_multi_modal_tpu.engine.evaluator import Classification as JaxClassification
import federated_multi_modal_tpu_torch.trainers  # noqa: F401 - registers the trainers
from federated_multi_modal_tpu_torch.config import get_cfg_default
from federated_multi_modal_tpu_torch.engine import build_trainer
from federated_multi_modal_tpu_torch.engine import checkpoint as port_ckpt
from federated_multi_modal_tpu_torch.engine import optim as port_optim
from federated_multi_modal_tpu_torch.engine import trainer as port_trainer
from federated_multi_modal_tpu_torch.engine.evaluator import Classification
from federated_multi_modal_tpu_torch.models import clip_model as port_clip
from federated_multi_modal_tpu_torch.ops import primitives as port_prim

SCHEDULES = [
    ("cosine", -1, "linear", True, ()),
    ("cosine", 1, "constant", True, ()),
    ("cosine", 3, "linear", True, ()),
    ("cosine", 2, "linear", False, ()),
    ("single_step", -1, "linear", True, (3,)),
    ("single_step", 1, "constant", True, (10, 20)),
    ("multi_step", 2, "linear", True, (3, 6)),
    ("constant", 1, "constant", False, ()),
]


@pytest.mark.parametrize("scheduler,warmup,warmup_type,recount,stepsize", SCHEDULES)
def test_lr_schedule_equal(scheduler, warmup, warmup_type, recount, stepsize):
    cfgs = []
    for defaults in (get_cfg_default, jax_defaults):
        cfg = defaults()
        cfg.OPTIM.LR = 0.0035
        cfg.OPTIM.MAX_EPOCH = 9
        cfg.OPTIM.LR_SCHEDULER = scheduler
        cfg.OPTIM.WARMUP_EPOCH = warmup
        cfg.OPTIM.WARMUP_TYPE = warmup_type
        cfg.OPTIM.WARMUP_RECOUNT = recount
        if stepsize:
            cfg.OPTIM.STEPSIZE = stepsize
        cfgs.append(cfg)
    port, ref = (m.build_lr_schedule(c.OPTIM) for m, c in ((port_optim, cfgs[0]),
                                                            (jax_optim, cfgs[1])))
    assert [port(e) for e in range(12)] == [ref(e) for e in range(12)]


def _rel_err(got, ref):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy()
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("clip", [0.0, 1.0], ids=["no_clip", "clip"])
@pytest.mark.parametrize("name", ["sgd", "adam", "adamw"])
def test_optimizer_matches_optax_over_ten_steps(name, clip):
    """``optimizer_from_cfg`` against the JAX package's ``build_optimizer``
    (optax under ``inject_hyperparams``) on the same config: ten steps of a
    small fp32 tree whose gradients' norm is ~8 (so the clip acts), the LR
    set anew before each step on both sides; every update, every param
    and the LR in the state within 1e-6 of the leaf's largest value."""
    cfgs = []
    for defaults in (get_cfg_default, jax_defaults):
        cfg = defaults()
        cfg.OPTIM.NAME = name
        cfg.OPTIM.WEIGHT_DECAY = 5e-4 if name != "adamw" else 1e-2
        cfg.OPTIM.GRAD_CLIP_NORM = clip
        cfg.OPTIM.SGD_NESTEROV = True
        cfgs.append(cfg.OPTIM)
    tx = port_optim.optimizer_from_cfg(cfgs[0], learning_rate=0.01)
    tx_jax = jax_optim.build_optimizer(cfgs[1], learning_rate=0.01)
    rng = np.random.default_rng(31)
    params = {"w": rng.standard_normal((6, 4)).astype(np.float32),
              "blk": [{"b": rng.standard_normal(5).astype(np.float32)}]}
    p_jax = jax.tree.map(jnp.asarray, params)
    p_t = {"w": torch.from_numpy(params["w"]), "blk": [{"b": torch.from_numpy(params["blk"][0]["b"])}]}
    st_jax, st = tx_jax.init(p_jax), tx.init(p_t)
    for step in range(10):
        lr = 0.01 * (0.8 ** step)
        st = port_optim.set_learning_rate(st, lr)
        st_jax = jax_optim.set_learning_rate(st_jax, lr)
        assert port_optim.get_learning_rate(st) == jax_optim.get_learning_rate(st_jax)
        g = {"w": (rng.standard_normal((6, 4)) * 2).astype(np.float32),
             "blk": [{"b": (rng.standard_normal(5) * 2).astype(np.float32)}]}
        u_jax, st_jax = tx_jax.update(jax.tree.map(jnp.asarray, g), st_jax, p_jax)
        u, st = tx.update({"w": torch.from_numpy(g["w"]),
                           "blk": [{"b": torch.from_numpy(g["blk"][0]["b"])}]}, st, p_t)
        p_jax = jax.tree.map(lambda p, d: p + d, p_jax, u_jax)
        p_t = {"w": p_t["w"] + u["w"], "blk": [{"b": p_t["blk"][0]["b"] + u["blk"][0]["b"]}]}
        for got, ref in ((u["w"], u_jax["w"]), (u["blk"][0]["b"], u_jax["blk"][0]["b"]),
                         (p_t["w"], p_jax["w"]), (p_t["blk"][0]["b"], p_jax["blk"][0]["b"])):
            assert _rel_err(got, ref) < 1e-6, (step, name)


def test_train_step_returns_the_loss_aux():
    """``make_train_step_with_aux`` hands the loss's aux back detached;
    ``make_train_step`` keeps its four results."""
    tx = port_optim.build_optimizer(lr=0.1)
    params = {"w": torch.ones(3)}

    def loss_fn(tr, frozen, batch):
        loss = (tr["w"] * batch).sum()
        return loss, {"half": loss * 0.5}

    out = port_trainer.make_train_step_with_aux(loss_fn, tx)(params, None, tx.init(params),
                                                             torch.arange(3.0))
    assert float(out[2]) == 3.0 and float(out[4]["half"]) == 1.5
    assert not out[4]["half"].requires_grad
    assert len(port_trainer.make_train_step(loss_fn, tx)(params, None, tx.init(params),
                                                         torch.arange(3.0))) == 4


@pytest.mark.parametrize("per_class", [False, True], ids=["summary", "per_class"])
def test_evaluator_same_lines_and_result(per_class, tmp_path):
    results, outs = [], []
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((37, 5))
    labels = rng.integers(0, 5, 37)
    for defaults, cls in ((get_cfg_default, Classification), (jax_defaults, JaxClassification)):
        cfg = defaults()
        cfg.TEST.PER_CLASS_RESULT = per_class
        cfg.TEST.COMPUTE_CMAT = per_class
        cfg.OUTPUT_DIR = str(tmp_path / cls.__module__)
        ev = cls(cfg, lab2cname={i: f"c{i}" for i in range(5)})
        ev.process(logits[:20], labels[:20])
        ev.process(logits[20:], labels[20:])
        buf = io.StringIO()
        with redirect_stdout(buf):
            results.append(ev.evaluate())
        outs.append(buf.getvalue().replace(str(tmp_path / cls.__module__), "<out>"))
    assert outs[0] == outs[1]
    assert results[0] == results[1]


# -- checkpoints both ways ------------------------------------------------------


def _tiny_cfg(defaults, root, out_dir, trainer):
    cfg = defaults()
    cfg.DATASET.ROOT = str(root)
    cfg.DATASET.NAME = "Synthetic"
    cfg.MODEL.BACKBONE.NAME = "Tiny"
    cfg.INPUT.SIZE = (32, 32)
    cfg.INPUT.CANVAS_SIZE = 40
    cfg.TRAINER.NAME = trainer
    cfg.TRAINER.MAPLE.PROMPT_DEPTH = 3
    cfg.TRAINER.COOP.N_CTX = 4
    cfg.TPU.DATA_PARALLEL = False
    cfg.OUTPUT_DIR = str(out_dir)
    cfg.SEED = 1
    cfg.VERBOSE = False
    return cfg


@pytest.fixture
def trainers(tmp_path, monkeypatch):
    """``build(trainer)`` -> (JAX trainer, port trainer on the CPU) on the
    same Tiny + Synthetic config, the module globals each sets put back."""
    for module, name in ((jax_prim, "_ATTENTION_IMPL"), (jax_prim, "_VISION_ATTN_WGRAD_BLOCKS"),
                         (jax_clip, "_TEXT_PACK_DEFAULT"), (port_prim, "_ATTENTION_IMPL"),
                         (port_clip, "_TEXT_PACK_DEFAULT"), (sys, "stdout")):
        monkeypatch.setattr(module, name, getattr(module, name))

    def build(trainer):
        jax_t = jax_build_trainer(_tiny_cfg(jax_defaults, tmp_path / "data",
                                            tmp_path / "jax", trainer))
        port_t = build_trainer(_tiny_cfg(get_cfg_default, tmp_path / "data",
                                         tmp_path / "port", trainer), device="cpu")
        return jax_t, port_t

    return build


def _flat_port(tree):
    return port_ckpt.flatten_params(tree)


@pytest.mark.parametrize("trainer,model", [("MaPLe", "MultiModalPromptLearner"),
                                           ("CoOp", "prompt_learner")])
def test_checkpoints_both_ways(trainer, model, trainers, tmp_path):
    """A JAX-saved checkpoint loads into the port's trainer and a
    port-saved one into the JAX package's: equal flat names and values,
    the class-conditioned buffers (``token_prefix``, ``token_suffix``)
    dropped on load. Both trainers start from other random draws."""
    jax_t, port_t = trainers(trainer)
    flat_jax = jax_ckpt.flatten_params(jax_t.trainable)
    flat_port = _flat_port(port_t.trainable)
    assert flat_jax.keys() == flat_port.keys()
    assert any(not np.array_equal(np.asarray(flat_jax[k], np.float32), flat_port[k])
               for k in flat_jax)

    jax_t.save_model(0, directory=str(tmp_path / "from-jax"))
    saved = port_ckpt.load_checkpoint(str(tmp_path / "from-jax" / model / "model.pth.tar-1"))
    assert any(k.endswith("token_prefix") for k in saved["state_dict"])
    assert isinstance(saved["optimizer"], port_ckpt.ForeignObject)
    port_t.load_model(str(tmp_path / "from-jax"), epoch=1)
    got = _flat_port(port_t.trainable)
    assert got.keys() == flat_jax.keys()
    for k, v in flat_jax.items():
        np.testing.assert_array_equal(got[k], np.asarray(v, np.float32), err_msg=k)

    # the other way: perturb the port's weights, save, load into JAX
    port_t.trainable = port_trainer.tree_map_with_path(lambda _, t: t + 0.25, port_t.trainable)
    port_t.save_model(1, directory=str(tmp_path / "from-port"))
    path = tmp_path / "from-port" / model / "model.pth.tar-2"
    assert isinstance(jax_ckpt.load_checkpoint(str(path))["optimizer"], dict)
    jax_t.load_model(str(tmp_path / "from-port"), epoch=2)
    back = jax_ckpt.flatten_params(jax_t.trainable)
    want = _flat_port(port_t.trainable)
    assert back.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(back[k], np.float32), v, err_msg=k)


def test_drop_class_conditioned_equal():
    sd = {"prompt_learner.token_prefix": 1, "token_suffix": 2, "prompt_learner.ctx": 3,
          "x.token_prefix_not": 4}
    assert port_ckpt.drop_class_conditioned(sd) == jax_ckpt.drop_class_conditioned(sd)


def test_unflatten_strict_shapes_raises():
    tree = {"a": torch.zeros(2, 3)}
    with pytest.raises(ValueError, match="Shape mismatch"):
        port_ckpt.unflatten_into(tree, {"a": np.zeros((3, 2))}, strict_shapes=True)
    kept, used = port_ckpt.unflatten_into(tree, {"a": np.zeros((3, 2))})
    assert kept["a"] is tree["a"] and not used


DIST_SETTINGS = [
    ("TRAIN", "PROFILE_DIR", "trace", "utils/profiling.py"),
    ("TPU", "DATA_PARALLEL_MULTIHOST", True, "parallel/multihost.py"),
    ("TPU", "MESH_SHAPE", (2, 2), "parallel/mesh.py"),
]


@pytest.mark.parametrize("section,key,value,module", DIST_SETTINGS,
                         ids=[u[1] for u in DIST_SETTINGS])
def test_settings_of_a_later_item_raise(section, key, value, module, tmp_path, monkeypatch):
    """(Named for what it held before these settings were ported; nothing
    raises now.) The settings that raised until their module was ported
    are read:
    ``TRAIN.PROFILE_DIR`` traces into its directory, ``TPU.DATA_PARALLEL_
    MULTIHOST`` leaves one process alone (no data parallelism without a
    process group, as in the JAX package), ``TPU.MESH_SHAPE`` lays out the
    client mesh."""
    from federated_multi_modal_tpu_torch.parallel import mesh
    from federated_multi_modal_tpu_torch.utils import profiling

    cfg = get_cfg_default()
    cfg[section][key] = str(tmp_path / value) if key == "PROFILE_DIR" else value
    if key == "PROFILE_DIR":
        with profiling.trace(cfg.TRAIN.PROFILE_DIR):
            torch.ones(4).sum()
        assert list(tmp_path.glob("trace/*.pt.trace.json")), module
    elif key == "DATA_PARALLEL_MULTIHOST":
        monkeypatch.setattr(mesh, "visible_devices", lambda device=None: [torch.device("cpu")])
        t = port_trainer.FunctionalTrainerMixin.__new__(port_trainer.FunctionalTrainerMixin)
        t.device = torch.device("cpu")
        t._setup_data_parallel(cfg)
        assert t._dp_devices is None and not t._dp_multihost, module
    else:
        got = mesh.make_mesh_from_cfg(cfg, 2, [torch.device("cpu")] * 4)
        assert got.shape == {"client": 2, "data": 2}, module


def test_data_parallel_over_devices_raises(monkeypatch):
    """(Named for what it held before data parallelism was ported; nothing
    raises now.) ``TPU.DATA_PARALLEL`` has nothing to do on one device and splits the
    batch over more than one (the trainer's device first); off, it uses
    none."""
    from federated_multi_modal_tpu_torch.parallel import mesh

    cfg = get_cfg_default()
    t = port_trainer.FunctionalTrainerMixin.__new__(port_trainer.FunctionalTrainerMixin)
    t.device = torch.device("cpu")
    t._setup_data_parallel(cfg)
    assert t._dp_devices is None
    monkeypatch.setattr(mesh, "visible_devices", lambda device=None: [torch.device("cpu")] * 2)
    t._setup_data_parallel(cfg)
    assert t._dp_devices == [torch.device("cpu")] * 2
    shards = t._dp_shard({"image": torch.arange(6.0).reshape(2, 3), "w": torch.tensor(1.0)})
    assert [s["image"].tolist() for _, s in shards] == [[[0.0, 1.0, 2.0]], [[3.0, 4.0, 5.0]]]
    assert all(float(s["w"]) == 1.0 for _, s in shards)
    cfg.TPU.DATA_PARALLEL = False
    t._setup_data_parallel(cfg)
    assert t._dp_devices is None


def test_attention_impl_auto_is_the_jax_rule():
    cfg = get_cfg_default()
    assert port_trainer.resolve_attention_impl(cfg, torch.device("cpu")) == "xla"
    assert port_trainer.resolve_attention_impl(cfg, torch.device("cuda")) == "pallas"
    cfg.TPU.ATTENTION_IMPL = "xla"
    assert port_trainer.resolve_attention_impl(cfg, torch.device("cuda")) == "xla"
