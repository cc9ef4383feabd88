"""The port's federated data and FedAvg against the JAX package's, on the
CPU: the PatternNet, Ucmerced and EuroSAT datasets on seeded trees in their
own folder layout, each package reading the split JSON the other wrote; the
unified label space of ``MaPLeFederated``; ``partition_dataset_iid``;
``ClientDataManager``; ``stack_client_trees``, ``unstack_client_trees``,
``fedavg_over_clients`` and ``tree_finite``."""

import json
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import federated_multi_modal_tpu.data.datasets  # noqa: F401 - registers the datasets
import federated_multi_modal_tpu.trainers  # noqa: F401 - registers the trainers
import federated_multi_modal_tpu_torch.data.datasets  # noqa: F401
import federated_multi_modal_tpu_torch.trainers  # noqa: F401
from federated_multi_modal_tpu import parallel as jax_parallel
from federated_multi_modal_tpu.config import get_cfg_default as jax_defaults
from federated_multi_modal_tpu.data.datum import Datum as JaxDatum
from federated_multi_modal_tpu.data.manager import ClientDataManager as JaxClientDataManager
from federated_multi_modal_tpu.data.partition import partition_dataset_iid as jax_partition
from federated_multi_modal_tpu.engine import build_trainer as jax_build_trainer
from federated_multi_modal_tpu.engine.registry import DATASET_REGISTRY as JAX_DATASETS
from federated_multi_modal_tpu.engine.trainer import tree_finite as jax_tree_finite
from federated_multi_modal_tpu.models import clip_model as jax_clip
from federated_multi_modal_tpu.ops import primitives as jax_prim
from federated_multi_modal_tpu_torch import parallel as port_parallel
from federated_multi_modal_tpu_torch.config import get_cfg_default
from federated_multi_modal_tpu_torch.data import seeded_trees
from federated_multi_modal_tpu_torch.data.datum import Datum
from federated_multi_modal_tpu_torch.data.manager import ClientDataManager
from federated_multi_modal_tpu_torch.data.partition import partition_dataset_iid
from federated_multi_modal_tpu_torch.engine import build_trainer
from federated_multi_modal_tpu_torch.engine.registry import DATASET_REGISTRY
from federated_multi_modal_tpu_torch.engine.trainer import tree_finite
from federated_multi_modal_tpu_torch.models import clip_model as port_clip
from federated_multi_modal_tpu_torch.ops import primitives as port_prim

# the published trees at 8 x 8 pixels; EuroSAT's splitter needs four images
# a class for a non-empty test split
PER_CLASS = {"PatternNet": 3, "Ucmerced": 3, "EuroSAT": 4}
SPLIT_JSON = {"PatternNet": "PatternNet/patternnet.json", "Ucmerced": "Ucmerced/Ucmerced.json",
              "EuroSAT": "eurosat/split_zhou_EuroSAT.json"}


def _cfg(defaults, root, name="", **fed):
    cfg = defaults()
    cfg.DATASET.ROOT = str(root)
    cfg.DATASET.NAME = name
    cfg.SEED = 1
    cfg.VERBOSE = False
    for key, value in fed.items():
        cfg.FED[key] = value
    return cfg


def _rows(split):
    return [(d.impath, d.label, d.classname, d.caption) for d in split]


def _splits(ds):
    return [_rows(getattr(ds, s)) for s in ("train_x", "val", "test")]


def _build(registry, defaults, root, name):
    # EuroSAT's splitter shuffles with the global ``random`` (seeded by
    # set_random_seed in a run)
    random.seed(0)
    return registry.get(name)(_cfg(defaults, root, name))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("remote-sensing")
    for name, n in PER_CLASS.items():
        seeded_trees.write_seeded_tree(str(root), name, n, seed=3, size=8)
    return root


@pytest.mark.parametrize("name", list(PER_CLASS))
def test_dataset_lists_and_split_json_cross_read(name, tree, tmp_path):
    """On one copy of the tree each package scans and splits it alone to
    the same lists, field for field (impath, label, classname, caption),
    and writes the same split JSON; each then reads the JSON the other
    wrote to the same lists."""
    import shutil

    root = tmp_path / "tree"
    shutil.copytree(tree, root)
    split_json = root / SPLIT_JSON[name]
    jax_ds = _build(JAX_DATASETS, jax_defaults, root, name)
    jax_json = split_json.read_text()
    split_json.unlink()
    port_ds = _build(DATASET_REGISTRY, get_cfg_default, root, name)
    port_json = split_json.read_text()
    assert _splits(port_ds) == _splits(jax_ds)
    assert all(_splits(port_ds)) and all(r[3] for split in _splits(port_ds) for r in split)
    assert json.loads(port_json) == json.loads(jax_json)

    # each package reads the JSON the other wrote
    assert _splits(_build(JAX_DATASETS, jax_defaults, root, name)) == _splits(jax_ds)
    split_json.write_text(jax_json)
    assert _splits(_build(DATASET_REGISTRY, get_cfg_default, root, name)) == _splits(port_ds)


def test_dataset_class_counts_and_renames(tree):
    """The public class lists: PatternNet 38, UC Merced 21 (8 folders
    renamed into PatternNet's names), EuroSAT 10 under its new names."""
    pn = _build(DATASET_REGISTRY, get_cfg_default, tree, "PatternNet")
    uc = _build(DATASET_REGISTRY, get_cfg_default, tree, "Ucmerced")
    eu = _build(DATASET_REGISTRY, get_cfg_default, tree, "EuroSAT")
    names = [{d.classname for s in ("train_x", "val", "test") for d in getattr(ds, s)}
             for ds in (pn, uc, eu)]
    assert [len(n) for n in names] == [38, 21, 10]
    assert {"tennis_court", "baseball_field", "storage_tank"} <= names[1]
    assert not {"tenniscourt", "baseballdiamond", "storagetanks"} & names[1]
    assert "Highway or Road" in names[2]


def test_eurosat_raises_on_a_missing_caption(tree, tmp_path):
    import shutil

    root = tmp_path / "eu"
    shutil.copytree(tree / "eurosat", root / "eurosat")
    os.remove(root / "eurosat" / "captions" / "Forest" / "Forest_2.txt")
    for registry, defaults in ((JAX_DATASETS, jax_defaults), (DATASET_REGISTRY, get_cfg_default)):
        with pytest.raises(FileNotFoundError, match="Caption file missing"):
            _build(registry, defaults, root, "EuroSAT")


def _img(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(np.random.default_rng(0).integers(0, 255, (8, 8, 3), np.uint8)).save(path)


@pytest.fixture(scope="module")
def unification_root(tmp_path_factory):
    """``tests/test_fed_unification.py``'s tree: PatternNet airplane and
    tennis_court, UC Merced tenniscourt (renamed into tennis_court) and
    harbor, EuroSAT Forest and River (the classname-only vocabulary)."""
    root = tmp_path_factory.mktemp("rs")
    for ds, img_dir, cats, pattern in (
            ("PatternNet", "images", ("airplane", "tennis_court"), "{c}{i:02d}"),
            ("Ucmerced", "Images", ("tenniscourt", "harbor"), "{c}{i:02d}"),
            ("eurosat", "2750", ("Forest", "River"), "{c}_{i}")):
        cap_dir = "captions" if ds == "eurosat" else "Captions"
        for c in cats:
            for i in range(6 if ds == "eurosat" else 10):
                stem = pattern.format(c=c, i=i)
                _img(str(root / ds / img_dir / c / f"{stem}.jpg"))
                p = root / ds / cap_dir / c / f"{stem}.txt"
                os.makedirs(p.parent, exist_ok=True)
                p.write_text(f"a photo of {c}")
    return root


def _fed_cfg(defaults, root, out):
    cfg = _cfg(defaults, root, "EuroSAT", NUM_CLIENTS=2, NUM_ROUNDS=1, LOCAL_EPOCHS=1)
    cfg.MODEL.BACKBONE.NAME = "Tiny"
    cfg.INPUT.SIZE = (32, 32)
    cfg.INPUT.CANVAS_SIZE = 40
    cfg.TRAINER.NAME = "MaPLeFederated"
    cfg.TRAINER.MAPLE.PROMPT_DEPTH = 3
    cfg.OUTPUT_DIR = str(out)
    cfg.TPU.DATA_PARALLEL = False
    return cfg


def test_unified_label_space_equals_jax(unification_root, tmp_path, monkeypatch):
    """``lab2cname``, ``cfg.MODEL.NUM_CLASSES``, each client's remapped
    lists (no domain field) and the clients' class count equal the JAX
    package's."""
    for module, attr in ((jax_prim, "_ATTENTION_IMPL"), (jax_prim, "_VISION_ATTN_WGRAD_BLOCKS"),
                         (jax_clip, "_TEXT_PACK_DEFAULT"), (port_prim, "_ATTENTION_IMPL"),
                         (port_clip, "_TEXT_PACK_DEFAULT")):
        monkeypatch.setattr(module, attr, getattr(module, attr))
    random.seed(0)
    ref = jax_build_trainer(_fed_cfg(jax_defaults, unification_root, tmp_path / "jax"))
    random.seed(0)
    port = build_trainer(_fed_cfg(get_cfg_default, unification_root, tmp_path / "port"),
                         device="cpu")
    assert port.lab2cname == ref.lab2cname
    assert list(port.lab2cname.values()) == ["Forest", "River", "airplane", "harbor",
                                             "tennis_court"]
    assert port.cfg.MODEL.NUM_CLASSES == ref.cfg.MODEL.NUM_CLASSES == port.num_classes == 5
    for got, want in zip(port.client_data_managers, ref.client_data_managers, strict=True):
        for split in ("train_x", "val", "test"):
            g, w = getattr(got.dataset, split), getattr(want.dataset, split)
            assert _rows(g) == _rows(w) and g, split
            assert {d.domain for d in g} == {0}
    assert [c.const.n_cls for c in port.clients] == [5, 5]


def _datums(datum_cls, n, classes=3):
    return [datum_cls(impath=f"img{i}.jpg", label=i % classes, classname=f"c{i % classes}",
                      caption=f"cap {i}") for i in range(n)]


@pytest.mark.parametrize("n_train,clients,seed", [(10, 2, 0), (11, 3, 1), (5, 5, 7)])
def test_partition_iid_equals_jax(n_train, clients, seed):
    from types import SimpleNamespace

    def dataset(datum_cls):
        return SimpleNamespace(train_x=_datums(datum_cls, n_train), val=_datums(datum_cls, 2),
                               test=_datums(datum_cls, 3))

    got = partition_dataset_iid(dataset(Datum), clients, seed=seed)
    want = jax_partition(dataset(JaxDatum), clients, seed=seed)
    assert len(got) == len(want) == clients
    for g, w in zip(got, want):
        for split in ("train_x", "val", "test"):
            assert _rows(g[split]) == _rows(w[split])
    assert sum(len(p["train_x"]) for p in got) == n_train


def test_client_data_manager_equals_jax(tmp_path):
    """The label gate's errors, ``lab2cname`` over every split (a class
    only in test included), ``num_classes`` and the loaders."""
    from federated_multi_modal_tpu_torch.data.datasets.synthetic import generate_synthetic_tree

    image_dir, _ = generate_synthetic_tree(str(tmp_path))
    paths = sorted(os.path.join(image_dir, c, f) for c in os.listdir(image_dir)
                   for f in os.listdir(os.path.join(image_dir, c)))

    def lists(datum_cls):
        mk = lambda i, label: datum_cls(impath=paths[i], label=label, classname=f"k{label}")  # noqa: E731
        return ([mk(i, i % 2) for i in range(8)], [mk(8, 1)], [mk(9, 0), mk(10, 4)])

    for defaults, mgr, datum_cls in ((get_cfg_default, ClientDataManager, Datum),
                                     (jax_defaults, JaxClientDataManager, JaxDatum)):
        cfg = _cfg(defaults, tmp_path)
        cfg.INPUT.SIZE = (32, 32)
        cfg.INPUT.CANVAS_SIZE = 40
        cfg.DATALOADER.TRAIN_X.BATCH_SIZE = 4
        train, val, test = lists(datum_cls)
        dm = mgr(train, val, test, cfg)
        assert dm.lab2cname == {0: "k0", 1: "k1", 4: "k4"}
        assert dm.num_classes == 5
        assert len(dm.train_loader_x) == 2 and dm.val_loader is not None
        assert mgr(train, [], test, cfg).val_loader is None
        bad = datum_cls(impath="x.jpg", label=-1)
        with pytest.raises(ValueError, match=r"Invalid label -1 in val \(impath=x.jpg\)"):
            mgr(train, [bad], test, cfg)


def _numpy_trees(seed, n, plant):
    """``n`` client trees of nested dicts and lists with a ``None`` leaf,
    fp32 and bf16 leaves (bf16 as fp32 values to be rounded), and ``plant``
    non-finite values."""
    rng = np.random.default_rng(seed)
    trees = []
    for c in range(n):
        t = {"a": rng.standard_normal((3, 5)).astype(np.float32),
             "b": [rng.standard_normal(7).astype(np.float32) * 1e3, None,
                   rng.standard_normal((2, 2)).astype(np.float32)],
             "h": rng.standard_normal((4, 6)).astype(np.float32),
             "skip": None}
        trees.append(t)
    for c, key, idx, value in plant:
        trees[c][key][idx] = value
    return trees


def _to_port(tree, bf16=("h",)):
    out = {}
    for k, v in tree.items():
        if v is None:
            out[k] = None
        elif isinstance(v, list):
            out[k] = [None if x is None else torch.from_numpy(x.copy()) for x in v]
        else:
            out[k] = torch.from_numpy(v.copy()).to(torch.bfloat16 if k in bf16 else torch.float32)
    return out


def _to_jax(tree, bf16=("h",)):
    out = {}
    for k, v in tree.items():
        if v is None:
            out[k] = None
        elif isinstance(v, list):
            out[k] = [None if x is None else jnp.asarray(x) for x in v]
        else:
            out[k] = jnp.asarray(v, jnp.bfloat16 if k in bf16 else jnp.float32)
    return out


def _flat(tree, prefix=""):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        name = f"{prefix}{k}"
        if isinstance(v, (dict, list)):
            out.update(_flat(v, name + "."))
        elif v is not None:
            arr = v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float32)
            out[name] = (arr, str(v.dtype).replace("torch.", ""))
    return out


def _assert_same(got, want):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in g:
        assert g[k][1] == w[k][1], (k, g[k][1], w[k][1])
        np.testing.assert_array_equal(g[k][0], w[k][0], err_msg=k)


PLANTS = {
    "finite": [],
    "nan_inf": [(0, "a", (1, 2), np.nan), (1, "a", (0, 0), np.inf), (1, "h", (2, 3), -np.inf),
                (0, "h", (0, 1), np.nan)],
}


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("plant", list(PLANTS))
def test_fedavg_trees_equal_jax(n, plant):
    """Stacking, the scrubbed fp32 mean cast back to each leaf's dtype and
    broadcast over the clients, unstacking and the validity gate: the JAX
    package's values and dtypes exactly, ``None`` leaves kept."""
    trees = _numpy_trees(n, n, PLANTS[plant])
    port_trees = [_to_port(t) for t in trees]
    jax_trees = [_to_jax(t) for t in trees]
    stacked = port_parallel.stack_client_trees(port_trees)
    jax_stacked = jax_parallel.stack_client_trees(jax_trees)
    _assert_same(stacked, jax_stacked)
    assert stacked["skip"] is None and stacked["b"][1] is None
    avg = port_parallel.fedavg_over_clients(stacked)
    _assert_same(avg, jax_parallel.fedavg_over_clients(jax_stacked))
    unstacked = port_parallel.unstack_client_trees(avg, n)
    for got, want in zip(unstacked, jax_parallel.unstack_client_trees(
            jax_parallel.fedavg_over_clients(jax_stacked), n)):
        _assert_same(got, want)
    for t_port, t_jax in zip(port_trees + [stacked], jax_trees + [jax_stacked]):
        assert tree_finite(t_port) == jax_tree_finite(t_jax)
    assert tree_finite(stacked) is (plant == "finite")
    assert tree_finite(port_parallel.fedavg_over_clients(stacked)) is True
    assert tree_finite({"x": None, "y": [None]}) is True


def test_tree_finite_reads_the_device_once(monkeypatch):
    """The gate makes one device-to-host read per call, whatever the
    number of leaves."""
    reads = []
    real_bool = torch.Tensor.__bool__
    monkeypatch.setattr(torch.Tensor, "__bool__", lambda t: reads.append(1) or real_bool(t))
    tree = {"l": [torch.ones(3) for _ in range(40)], "n": None}
    assert tree_finite(tree) is True
    assert len(reads) == 1
