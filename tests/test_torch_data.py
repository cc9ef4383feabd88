"""The port's data path (``federated_multi_modal_tpu_torch/data``,
``native``) against the JAX package's: the Synthetic tree and its Datums,
the ``DataManager`` splits, the loaders' batches over two epochs, and the
native codec's bytes."""

import os

import numpy as np
import pytest

from federated_multi_modal_tpu import native as jax_native
from federated_multi_modal_tpu.config import get_cfg_default as jax_defaults
from federated_multi_modal_tpu.data.datasets import synthetic as jax_synthetic
from federated_multi_modal_tpu.data.manager import DataManager as JaxDataManager
from federated_multi_modal_tpu_torch import native as port_native
from federated_multi_modal_tpu_torch.config import get_cfg_default
from federated_multi_modal_tpu_torch.data.datasets import synthetic as port_synthetic
from federated_multi_modal_tpu_torch.data.manager import DataManager


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """One Synthetic tree written by each package."""
    jax_root = tmp_path_factory.mktemp("jax-data")
    port_root = tmp_path_factory.mktemp("port-data")
    jax_synthetic.generate_synthetic_tree(str(jax_root))
    port_synthetic.generate_synthetic_tree(str(port_root))
    return jax_root, port_root


def _cfg(defaults, root, **overrides):
    cfg = defaults()
    cfg.DATASET.ROOT = str(root)
    cfg.DATASET.NAME = "Synthetic"
    cfg.INPUT.SIZE = (32, 32)
    cfg.INPUT.CANVAS_SIZE = 40
    cfg.DATALOADER.TRAIN_X.BATCH_SIZE = 4
    cfg.DATALOADER.TEST.BATCH_SIZE = 8
    cfg.SEED = 1
    cfg.VERBOSE = False
    for key, value in overrides.items():
        section, name = key.split("__")
        cfg[section][name] = value
    return cfg


def _tree_files(root):
    base = os.path.join(str(root), "synthetic")
    return sorted(os.path.relpath(os.path.join(d, f), base)
                  for d, _, fs in os.walk(base) for f in fs)


def test_synthetic_tree_written_the_same(roots):
    jax_root, port_root = roots
    files = _tree_files(jax_root)
    assert files == _tree_files(port_root) and len(files) == 96
    for rel in files:
        with open(os.path.join(str(jax_root), "synthetic", rel), "rb") as a, \
                open(os.path.join(str(port_root), "synthetic", rel), "rb") as b:
            assert a.read() == b.read(), rel


def test_synthetic_reads_without_pillow_once_written(roots, monkeypatch):
    """Reading a tree that exists imports no Pillow."""
    import builtins

    real_import = builtins.__import__

    def guarded(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no Pillow here")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", guarded)
    image_dir, _ = port_synthetic.generate_synthetic_tree(str(roots[1]))
    assert os.path.isdir(image_dir)


def _datums(split):
    return [(d.impath, d.label, d.domain, d.classname, d.caption) for d in split]


def test_datums_splits_and_lab2cname_equal(roots):
    jax_root, _ = roots
    port = DataManager(_cfg(get_cfg_default, jax_root))
    ref = JaxDataManager(_cfg(jax_defaults, jax_root))
    for split in ("train_x", "val", "test"):
        got, want = getattr(port.dataset, split), getattr(ref.dataset, split)
        assert _datums(got) == _datums(want), split
        assert got
    assert port.lab2cname == ref.lab2cname
    assert port.dataset.classnames == ref.dataset.classnames
    assert port.num_classes == ref.num_classes == 4
    assert all(d.caption for d in port.dataset.train_x)


BATCH_KEYS = ("label", "caption", "impath", "index", "canvas", "box", "flip", "img")


@pytest.mark.parametrize("pipeline,native", [("device", True), ("device", False),
                                             ("host", False)],
                         ids=["device-native", "device-pil", "host"])
def test_loader_batches_equal_over_two_epochs(roots, pipeline, native):
    """Train and test batches of two epochs, bit for bit: canvas (or the
    host pipeline's image), box, flip, label, caption, path, index. The
    host pipeline's transforms draw from an unseeded generator in both
    packages; the test gives each the same seeded one."""
    jax_root, _ = roots
    over = {"INPUT__PIPELINE": pipeline, "INPUT__NATIVE_DECODE": native}
    port = DataManager(_cfg(get_cfg_default, jax_root, **over))
    ref = JaxDataManager(_cfg(jax_defaults, jax_root, **over))
    if pipeline == "host":
        for dm in (port, ref):
            dm.train_loader_x.transform.rng = np.random.default_rng(5)
    uses_codec = [getattr(dm.train_loader_x.transform, "native", False) for dm in (port, ref)]
    assert uses_codec == [native, native]
    for loader in ("train_loader_x", "test_loader"):
        for epoch in range(2):
            got = list(getattr(port, loader))
            want = list(getattr(ref, loader))
            assert len(got) == len(want) > 0
            for b_got, b_want in zip(got, want):
                assert b_got.keys() == b_want.keys()
                for key in BATCH_KEYS:
                    if key in b_want:
                        np.testing.assert_array_equal(np.asarray(b_got[key]),
                                                      np.asarray(b_want[key]),
                                                      err_msg=f"{loader} {epoch} {key}")


@pytest.fixture(scope="module")
def png_path(tmp_path_factory):
    from PIL import Image

    rng = np.random.default_rng(3)
    path = tmp_path_factory.mktemp("png") / "rgba.png"
    Image.fromarray(rng.integers(0, 255, (37, 53, 4), np.uint8)).save(path)
    return str(path)


@pytest.mark.parametrize("interp", ["bicubic", "bilinear", "nearest"])
@pytest.mark.parametrize("crop_square", [False, True], ids=["squash", "crop"])
def test_codec_decodes_the_same_bytes(roots, png_path, interp, crop_square):
    """The port's codec (its own build of its own copy of ``imagecodec.cc``)
    decodes the tree's JPEGs and a PNG to the JAX package's bytes, one by
    one and as a batch."""
    assert port_native.available() and jax_native.available()
    assert port_native.library_path() != jax_native._SO
    jax_root, _ = roots
    image_dir = os.path.join(str(jax_root), "synthetic", "images")
    paths = [os.path.join(image_dir, c, f) for c in sorted(os.listdir(image_dir))
             for f in sorted(os.listdir(os.path.join(image_dir, c)))[:3]] + [png_path]
    for path in paths:
        got = port_native.decode_to_canvas(path, 40, interp, crop_square=crop_square)
        want = jax_native.decode_to_canvas(path, 40, interp, crop_square=crop_square)
        np.testing.assert_array_equal(got, want, err_msg=path)
    got, st = port_native.decode_batch(paths, 24, interp, crop_square=crop_square, n_threads=2)
    want, st_want = jax_native.decode_batch(paths, 24, interp, crop_square=crop_square,
                                            n_threads=2)
    np.testing.assert_array_equal(st, st_want)
    assert not st.any()
    np.testing.assert_array_equal(got, want)
