"""The port's 14 base-to-novel dataset modules against the JAX package's, on
fabricated miniature trees in each dataset's own layout (the layouts of
``tests/test_dataset_plugins.py`` and ``tests/test_dataset_plugins_more.py``,
with more classes and images so that every split, few-shot draw and
base/new half is non-trivial), and the port's reading of the dataset caches
the JAX package writes.

Both packages split with the global ``random`` module; each construction
here is preceded by the same ``random.seed``. Lists are compared field for
field (impath, label, domain, classname, caption).
"""

import json
import os
import pickle
import random
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

import federated_multi_modal_tpu.data.datasets  # noqa: F401 - registers the datasets
import federated_multi_modal_tpu_torch.data.datasets  # noqa: F401
from federated_multi_modal_tpu.config import get_cfg_default as jax_defaults
from federated_multi_modal_tpu.engine.registry import DATASET_REGISTRY as JAX_DATASETS
from federated_multi_modal_tpu_torch.config import get_cfg_default as port_defaults
from federated_multi_modal_tpu_torch.engine.registry import DATASET_REGISTRY as PORT_DATASETS

ROOT = Path(__file__).resolve().parents[1]
SEED = 1
SHOTS = 2


def _touch(path, content=b"x"):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(content)


def _classnames_txt(path, pairs):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.writelines(f"{wnid} {name}\n" for wnid, name in pairs)


# -- the trees, one writer per dataset -----------------------------------------------

WNIDS = [("n01440764", "tench"), ("n01443537", "goldfish"),
         ("n01484850", "great white shark"), ("n01491361", "tiger shark")]


def caltech101_tree(root):
    base = root / "caltech-101" / "101_ObjectCategories"
    for cat in ("airplanes", "Faces", "BACKGROUND_Google", "Faces_easy", "ant", "Leopards"):
        for i in range(6):
            _touch(str(base / cat / f"image_{i + 1:04d}.jpg"))


def dtd_tree(root):
    for cat in ("banded", "dotted", "grid", "zigzagged"):
        for i in range(6):
            _touch(str(root / "dtd" / "images" / cat / f"{cat}_{i:04d}.jpg"))


def food101_tree(root):
    for cat in ("apple_pie", "baklava", "churros", "ramen"):
        for i in range(6):
            _touch(str(root / "food-101" / "images" / cat / f"{i:07d}.jpg"))


def oxford_pets_tree(root):
    base = root / "oxford_pets"
    trainval, test = [], []
    for label, breed in enumerate(("Abyssinian", "beagle", "Bengal", "boxer"), start=1):
        for i in range(1, 8):
            _touch(str(base / "images" / f"{breed}_{i}.jpg"))
            (trainval if i <= 5 else test).append(f"{breed}_{i} {label} 1 1")
    _touch(str(base / "annotations" / "trainval.txt"), "\n".join(trainval).encode())
    _touch(str(base / "annotations" / "test.txt"), "\n".join(test).encode())


def oxford_flowers_tree(root):
    from scipy.io import savemat

    base = root / "oxford_flowers"
    base.mkdir(parents=True)
    labels = np.repeat(np.arange(1, 5), 6)[np.random.default_rng(0).permutation(24)]
    savemat(str(base / "imagelabels.mat"), {"labels": labels[None]})
    names = ["pink primrose", "hard-leaved pocket orchid", "canterbury bells", "sweet pea"]
    (base / "cat_to_name.json").write_text(json.dumps({str(i + 1): n for i, n in enumerate(names)}))
    for i in range(24):
        _touch(str(base / "jpg" / f"image_{i + 1:05d}.jpg"))


def stanford_cars_tree(root):
    from scipy.io import savemat

    base = root / "stanford_cars"
    (base / "devkit").mkdir(parents=True)

    def annos(prefix, n):
        rec = np.zeros((1, n), dtype=[("fname", "O"), ("class", "O")])
        for i in range(n):
            rec[0, i] = (f"{prefix}_{i:05d}.jpg", np.array([[i % 4 + 1]]))
        return {"annotations": rec}

    savemat(str(base / "devkit" / "cars_train_annos.mat"), annos("tr", 20))
    savemat(str(base / "cars_test_annos_withlabels.mat"), annos("te", 8))
    savemat(str(base / "devkit" / "cars_meta.mat"), {"class_names": np.array(
        [["Acura TL Sedan 2012", "BMW X3 SUV 2011", "Audi R8 Coupe 2012",
          "Tesla Model S Sedan 2012"]], dtype=object)})
    for i in range(20):
        _touch(str(base / "cars_train" / f"tr_{i:05d}.jpg"))
    for i in range(8):
        _touch(str(base / "cars_test" / f"te_{i:05d}.jpg"))


def fgvc_aircraft_tree(root):
    base = root / "fgvc_aircraft"
    variants = ["707-320", "A310", "BAE 146-200", "Cessna 172"]
    (base / "images").mkdir(parents=True)
    (base / "variants.txt").write_text("\n".join(variants) + "\n")
    for split, n in (("train", 3), ("val", 2), ("test", 2)):
        lines = []
        for v, variant in enumerate(variants):
            for i in range(n):
                imname = f"{split}{v}{i:04d}"
                _touch(str(base / "images" / f"{imname}.jpg"))
                lines.append(f"{imname} {variant}")
        (base / f"images_variant_{split}.txt").write_text("\n".join(lines))


def sun397_tree(root):
    base = root / "sun397"
    base.mkdir()
    classes = ["/a/abbey", "/b/bedroom/indoor", "/c/canyon", "/d/dock/outdoor"]
    (base / "ClassName.txt").write_text("\n".join(classes) + "\n")
    train, test = [], []
    for cls in classes:
        for i in range(6):
            rel = f"{cls}/sun_{i:03d}.jpg"
            _touch(str(base / "SUN397" / rel.lstrip("/")))
            (train if i < 4 else test).append(rel)
    (base / "Training_01.txt").write_text("\n".join(train) + "\n")
    (base / "Testing_01.txt").write_text("\n".join(test) + "\n")


def ucf101_tree(root):
    base = root / "ucf101"
    actions = ["ApplyEyeMakeup", "Basketball", "PlayingCello", "YoYo"]
    (base / "ucfTrainTestlist").mkdir(parents=True)
    (base / "ucfTrainTestlist" / "classInd.txt").write_text(
        "\n".join(f"{i + 1} {a}" for i, a in enumerate(actions)) + "\n")
    train, test = [], []
    for action in actions:
        renamed = "_".join(__import__("re").findall("[A-Z][^A-Z]*", action))
        for i in range(6):
            fn = f"v_{action}_g{i:02d}_c01.avi"
            _touch(str(base / "UCF-101-midframes" / renamed / fn.replace(".avi", ".jpg")))
            (train if i < 4 else test).append(f"{action}/{fn} 1")
    (base / "ucfTrainTestlist" / "trainlist01.txt").write_text("\n".join(train))
    (base / "ucfTrainTestlist" / "testlist01.txt").write_text("\n".join(test))


def imagenet_tree(root):
    base = root / "imagenet"
    _classnames_txt(str(base / "classnames.txt"), WNIDS)
    for wnid, _ in WNIDS:
        for split, n in (("train", 4), ("val", 2)):
            for i in range(n):
                _touch(str(base / "images" / split / wnid / f"{wnid}_{i}.JPEG"))


def imagenet_sketch_tree(root):
    base = root / "imagenet-sketch"
    _classnames_txt(str(base / "classnames.txt"), WNIDS)
    for wnid, _ in WNIDS:
        for i in range(3):
            _touch(str(base / "images" / wnid / f"sketch_{i}.jpg"))


def _readme_tree(root, dirname, imdir):
    base = root / dirname
    _classnames_txt(str(base / "classnames.txt"), WNIDS)
    _touch(str(base / imdir / "README.txt"))
    for wnid, _ in WNIDS[1:]:
        for i in range(2):
            _touch(str(base / imdir / wnid / f"{i}.jpg"))


def imagenetv2_tree(root):
    base = root / "imagenetv2"
    _classnames_txt(str(base / "classnames.txt"), [(f"n{i:08d}", f"class {i}")
                                                   for i in range(1000)])
    for label in range(1000):
        for i in range(1 + label % 2):
            _touch(str(base / "imagenetv2-matched-frequency-format-val" / str(label)
                       / f"{i}.jpeg"))


TREES = {
    "Caltech101": caltech101_tree,
    "DescribableTextures": dtd_tree,
    "Food101": food101_tree,
    "OxfordPets": oxford_pets_tree,
    "OxfordFlowers": oxford_flowers_tree,
    "StanfordCars": stanford_cars_tree,
    "FGVCAircraft": fgvc_aircraft_tree,
    "SUN397": sun397_tree,
    "UCF101": ucf101_tree,
    "ImageNet": imagenet_tree,
    "ImageNetSketch": imagenet_sketch_tree,
    "ImageNetA": lambda root: _readme_tree(root, "imagenet-adversarial", "imagenet-a"),
    "ImageNetR": lambda root: _readme_tree(root, "imagenet-rendition", "imagenet-r"),
    "ImageNetV2": imagenetv2_tree,
}
# the datasets whose first construction writes a split file
SPLIT_FILE = {"Caltech101", "DescribableTextures", "Food101", "OxfordPets", "OxfordFlowers",
              "StanfordCars", "SUN397", "UCF101"}


# -- helpers -------------------------------------------------------------------------


def _cfg(defaults, root, name, shots=-1, subsample="all"):
    cfg = defaults()
    cfg.DATASET.ROOT = str(root)
    cfg.DATASET.NAME = name
    cfg.DATASET.NUM_SHOTS = shots
    cfg.DATASET.SUBSAMPLE_CLASSES = subsample
    cfg.SEED = SEED
    cfg.VERBOSE = False
    return cfg


def _build(package, root, name, **kwargs):
    """Dataset ``name`` of ``package`` ("jax" or "port") over ``root``,
    after ``random.seed(SEED)``."""
    defaults, registry = ((jax_defaults, JAX_DATASETS) if package == "jax"
                          else (port_defaults, PORT_DATASETS))
    random.seed(SEED)
    return registry.get(name)(_cfg(defaults, root, name, **kwargs))


def _rows(items):
    return [(d.impath, d.label, d.domain, d.classname, d.caption) for d in items]


def _lists(ds):
    return {"train": _rows(ds.train_x), "val": _rows(ds.val), "test": _rows(ds.test),
            "classnames": list(ds.classnames), "lab2cname": dict(ds.lab2cname),
            "num_classes": ds.num_classes}


def _files(root):
    return {p for p in root.rglob("*")}


def _written_since(root, before):
    """The files and directories written under ``root`` since ``before``."""
    return sorted(_files(root) - before, key=lambda p: len(p.parts), reverse=True)


def _remove(paths):
    for p in paths:
        p.rmdir() if p.is_dir() else p.unlink()


@pytest.fixture
def tree(request, tmp_path):
    TREES[request.param](tmp_path)
    return request.param, tmp_path


# -- the lists, the split files, the few-shot draws and the class halves --------------


@pytest.mark.parametrize("tree", list(TREES), indirect=True)
def test_lists_match_jax(tree):
    """Generated from the tree alone (every file the JAX package wrote
    removed first): the port's train, val and test lists, class names and
    label map equal the JAX package's."""
    name, root = tree
    before = _files(root)
    ref = _lists(_build("jax", root, name))
    written = _written_since(root, before)
    assert bool([p for p in written if p.name.startswith("split_zhou")]) == (name in SPLIT_FILE)
    _remove(written)
    got = _lists(_build("port", root, name))
    assert got == ref
    assert ref["train"] and ref["test"]


@pytest.mark.parametrize("tree", list(TREES), indirect=True)
def test_each_package_reads_the_others_split_files(tree):
    """A split JSON (ImageNet: its ``preprocessed.pkl``) that one package
    writes, the other reads to the same lists: JAX writes and the port reads,
    then the port writes and the JAX package reads. The reader draws from
    another seed, so a list it generated itself would differ."""
    name, root = tree
    before = _files(root)
    for writer, reader in (("jax", "port"), ("port", "jax")):
        ref = _lists(_build(writer, root, name))
        random.seed(SEED + 1000)
        defaults, registry = ((jax_defaults, JAX_DATASETS) if reader == "jax"
                              else (port_defaults, PORT_DATASETS))
        got = _lists(registry.get(name)(_cfg(defaults, root, name)))
        assert got == ref, (writer, reader)
        _remove(_written_since(root, before))


@pytest.mark.parametrize("tree", list(TREES), indirect=True)
def test_fewshot_and_class_halves_match_jax(tree):
    """``NUM_SHOTS`` 2 with ``SUBSAMPLE_CLASSES`` base and new: the port's
    lists equal the JAX package's, drawn by each from scratch and read by
    the port from the JAX package's few-shot cache."""
    name, root = tree
    before = _files(root)
    for subsample in ("base", "new"):
        ref = _lists(_build("jax", root, name, shots=SHOTS, subsample=subsample))
        random.seed(SEED + 1000)
        from_cache = _lists(PORT_DATASETS.get(name)(
            _cfg(port_defaults, root, name, shots=SHOTS, subsample=subsample)))
        assert from_cache == ref, subsample
        _remove(_written_since(root, before))
        got = _lists(_build("port", root, name, shots=SHOTS, subsample=subsample))
        _remove(_written_since(root, before))
        assert got == ref, subsample
        if name in SPLIT_FILE or name in ("FGVCAircraft", "ImageNet"):
            assert ref["num_classes"] == 2  # four classes, halved
            assert max(_count_by_label(ref["train"]).values()) <= SHOTS


def _count_by_label(rows):
    out = {}
    for row in rows:
        out[row[1]] = out.get(row[1], 0) + 1
    return out


# -- the caches the JAX package writes, read without importing it ---------------------

_READER = """
import json, random, sys
sys.path.insert(0, {repo!r})
import federated_multi_modal_tpu_torch.data.datasets  # noqa: F401
from federated_multi_modal_tpu_torch.config import get_cfg_default
from federated_multi_modal_tpu_torch.engine.registry import DATASET_REGISTRY
out = {{}}
for name in ("ImageNet", "DescribableTextures"):
    cfg = get_cfg_default()
    cfg.DATASET.ROOT = {root!r}
    cfg.DATASET.NAME = name
    cfg.DATASET.NUM_SHOTS = {shots}
    cfg.SEED = {seed}
    random.seed({seed} + 1000)  # a cache regenerated here would differ
    ds = DATASET_REGISTRY.get(name)(cfg)
    out[name] = {{k: [[d.impath, d.label, d.domain, d.classname, d.caption] for d in v]
                 for k, v in (("train", ds.train_x), ("val", ds.val), ("test", ds.test))}}
    out[name]["datum"] = type(ds.train_x[0]).__module__
out["imported"] = sorted(m for m in sys.modules
                         if m.split(".")[0] in ("jax", "jaxlib", "federated_multi_modal_tpu"))
print("RESULT " + json.dumps(out))
"""


def _read_in_port_process(root):
    """The port's ImageNet and DTD at ``NUM_SHOTS`` 2 over ``root``, in a
    fresh process: their lists, the module of their ``Datum``, the JAX
    modules that process imported, and its output."""
    script = _READER.format(repo=str(ROOT), root=str(root), shots=SHOTS, seed=SEED)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=300, cwd=str(root))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT "))
    out = json.loads(line[len("RESULT "):])
    return out, proc.stdout


def _jax_caches(root):
    """The JAX package's ImageNet and DTD at ``NUM_SHOTS`` 2 over ``root``,
    which write ImageNet's ``preprocessed.pkl`` and both few-shot caches:
    their lists."""
    imagenet_tree(root)
    dtd_tree(root)
    out = {}
    for name in ("ImageNet", "DescribableTextures"):
        ds = _build("jax", root, name, shots=SHOTS)
        out[name] = {k: [list(r) for r in _rows(v)]
                     for k, v in (("train", ds.train_x), ("val", ds.val), ("test", ds.test))}
    caches = [root / "imagenet" / "preprocessed.pkl",
              root / "imagenet" / "split_fewshot" / f"shot_{SHOTS}-seed_{SEED}.pkl",
              root / "dtd" / "split_fewshot" / f"shot_{SHOTS}-seed_{SEED}.pkl"]
    assert all(p.is_file() for p in caches)
    return out, caches


def test_port_reads_jax_caches_without_importing_jax(tmp_path):
    """A port process reads ImageNet's ``preprocessed.pkl`` and the few-shot
    caches the JAX package wrote: the lists equal the JAX package's, its
    ``Datum`` is the port's, no cache is rewritten, and neither the JAX
    package nor ``jax`` is imported."""
    ref, caches = _jax_caches(tmp_path)
    stamps = [(p.stat().st_mtime_ns, p.read_bytes()) for p in caches]
    got, stdout = _read_in_port_process(tmp_path)
    for name in ("ImageNet", "DescribableTextures"):
        assert got[name].pop("datum") == "federated_multi_modal_tpu_torch.data.datum"
        assert got[name] == ref[name], name
    assert got["imported"] == []
    assert "regenerating" not in stdout and "incompatible" not in stdout
    assert [(p.stat().st_mtime_ns, p.read_bytes()) for p in caches] == stamps


def _dassl_datum(monkeypatch):
    """An instance of a stand-in for Dassl's ``Datum``, pickled under
    Dassl's module path (modules set in ``sys.modules`` for the writer)."""
    path = "dassl.data.datasets.base_dataset"
    cls = type("Datum", (), {"__module__": path, "__qualname__": "Datum"})
    parts = path.split(".")
    for i in range(1, len(parts) + 1):
        monkeypatch.setitem(sys.modules, ".".join(parts[:i]),
                            types.ModuleType(".".join(parts[:i])))
    sys.modules[path].Datum = cls
    return cls()


@pytest.mark.parametrize("planted", ["jax-package-class", "dassl-class"])
def test_cache_naming_another_class_is_regenerated(planted, tmp_path, monkeypatch):
    """A cache that names any class of the JAX package other than its
    ``Datum`` (here its ``DatasetBase``), or a class of Dassl, is refused and
    regenerated, not loaded: the files then hold the port's ``Datum``, the
    lists are drawn anew from the same split, and nothing of JAX is
    imported."""
    from federated_multi_modal_tpu.data.dataset_base import DatasetBase

    ref, caches = _jax_caches(tmp_path)
    with monkeypatch.context() as mp:
        obj = DatasetBase() if planted == "jax-package-class" else _dassl_datum(mp)
        for path in caches:
            with open(path, "rb") as f:
                payload = pickle.load(f)
            payload["planted"] = obj
            with open(path, "wb") as f:
                pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    got, stdout = _read_in_port_process(tmp_path)
    assert stdout.count("regenerating") == 3, stdout[-2000:]
    assert ("federated_multi_modal_tpu.data.dataset_base.DatasetBase" if planted ==
            "jax-package-class" else "dassl.data.datasets.base_dataset.Datum") in stdout
    assert got["imported"] == []
    for name in ("ImageNet", "DescribableTextures"):
        assert got[name].pop("datum") == "federated_multi_modal_tpu_torch.data.datum"
        assert got[name]["test"] == ref[name]["test"]
        assert len(got[name]["train"]) == len(ref[name]["train"])
    for path in caches:
        with open(path, "rb") as f:
            rewritten = pickle.load(f)
        assert "planted" not in rewritten
        assert type(rewritten["train"][0]).__module__ == (
            "federated_multi_modal_tpu_torch.data.datum")
