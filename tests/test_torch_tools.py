"""The port's tools (``federated_multi_modal_tpu_torch/tools/``) against the
repository's ``tools/``, and the framework-free tools on the port's files,
on the CPU with the Tiny backbone and the Synthetic dataset.

* ``interpret_prompts``: ``nearest_words`` on the same arrays, and ``main``
  on the port's MaPLe and CoOp (class-specific ctx) checkpoints. The JAX tool
  fixes ``WEIGHTS_PATH`` to ``""`` and the two packages' random inits differ,
  so each tool's ``load_clip_backbone`` is replaced by one that reads the
  same seeded Tiny state dict.
* ``lpclip/feat_extractor``: both tools' ``{split}.npz`` from one seeded
  state dict given through ``MODEL.BACKBONE.WEIGHTS_PATH`` in
  ``--config-file``, in fp32 (each package's dtype policy replaced by the
  identity, the host pipeline's fp32 images); ``tools/lpclip/linear_probe.py``
  reads the port's three files unchanged.
* ``tools/convert_reference_checkpoint.py``'s output, from reference-named
  state dicts built here, read by the port's ``load_checkpoint`` and by its
  trainers under ``--eval-only``; ``--reverse`` on a port checkpoint.
* ``tools/captiongen.py --placeholder``'s tree read by the port's
  PatternNet, UC Merced and EuroSAT readers.
"""

import importlib.util
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from federated_multi_modal_tpu.engine.checkpoint import unflatten_into as jax_unflatten_into
from federated_multi_modal_tpu.models import params as jax_params
from federated_multi_modal_tpu_torch import train as port_cli
from federated_multi_modal_tpu_torch.config import get_cfg_default
from federated_multi_modal_tpu_torch.data.seeded_trees import LAYOUTS, write_seeded_tree
from federated_multi_modal_tpu_torch.engine.checkpoint import load_checkpoint
from federated_multi_modal_tpu_torch.engine.registry import build_dataset
from federated_multi_modal_tpu_torch.engine.tree import flatten
from federated_multi_modal_tpu_torch.models import clip_model as port_clip
from federated_multi_modal_tpu_torch.models import params as port_params
from federated_multi_modal_tpu_torch.ops import primitives as port_prim
from federated_multi_modal_tpu_torch.tools import interpret_prompts as port_interpret
from federated_multi_modal_tpu_torch.tools.lpclip import feat_extractor as port_feat

ROOT = Path(__file__).resolve().parents[1]
SYNTHETIC_YAML = str(ROOT / "configs/datasets/synthetic.yaml")
TINY = ["MODEL.BACKBONE.NAME", "Tiny", "INPUT.SIZE", "(32, 32)", "INPUT.CANVAS_SIZE", "40",
        "DATALOADER.TEST.BATCH_SIZE", "8", "VERBOSE", "False"]
# the features of both tools in fp32: the arithmetic is the same, only the
# order of sums differs
FEATURE_RTOL = 1e-5


def _tool(name, rel):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jax_interpret = _tool("jax_interpret_prompts", "tools/interpret_prompts.py")
jax_feat = _tool("jax_feat_extractor", "tools/lpclip/feat_extractor.py")
linear_probe = _tool("linear_probe_tool", "tools/lpclip/linear_probe.py")
converter = _tool("convert_reference_checkpoint_tool", "tools/convert_reference_checkpoint.py")
captiongen = _tool("captiongen_tool", "tools/captiongen.py")


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A Tiny CLIP in OpenAI's layout (fp16, as OpenAI ships it)."""
    arch = port_params.BACKBONE_CONFIGS["Tiny"]
    params = port_params.init_clip_params(arch, torch.Generator().manual_seed(5),
                                          dtype_policy=False)
    path = tmp_path_factory.mktemp("weights") / "tiny_openai.pt"
    torch.save(port_params.export_openai_state_dict(params, arch), path)
    return path


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return tmp_path_factory.mktemp("data")


def _port_main(argv):
    """The port's ``train.py`` ``main`` on the CPU, its module globals and
    ``sys.stdout`` (tee'd into ``log.txt``) put back afterwards."""
    args = port_cli.build_parser().parse_args(argv)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "stdout", sys.stdout)
        mp.setenv("FMM_TPU_PLATFORM", "cpu")
        for module, attr in ((port_prim, "_ATTENTION_IMPL"), (port_clip, "_TEXT_PACK_DEFAULT")):
            mp.setattr(module, attr, getattr(module, attr))
        return port_cli.main(args)


TRAINERS = {
    "MaPLe": ("configs/trainers/MaPLe/vit_b16_c2_ep5_batch4_2ctx.yaml",
              ["TRAINER.MAPLE.PROMPT_DEPTH", "3"], "MultiModalPromptLearner"),
    "CoOp": ("configs/trainers/CoOp/vit_b16.yaml",
             ["TRAINER.COOP.N_CTX", "4", "TRAINER.COOP.CSC", "True",
              "DATALOADER.TRAIN_X.BATCH_SIZE", "4"], "prompt_learner"),
    "CoCoOp": ("configs/trainers/CoCoOp/vit_b16_c4_ep10_batch1.yaml", [], "prompt_learner"),
    "IVLP": ("configs/trainers/IVLP/vit_b16_c2_ep5_batch4_2+2ctx.yaml",
             ["TRAINER.IVLP.PROMPT_DEPTH_TEXT", "3", "TRAINER.IVLP.PROMPT_DEPTH_VISION", "3"],
             "VLPromptLearner"),
    "VPT": ("configs/trainers/VPT/vit_b16_c2_ep5_batch4_4.yaml",
            ["TRAINER.VPT.PROMPT_DEPTH_VISION", "3"], "prompt_learner"),
}


def _argv(trainer, out_dir, data_root, weights, extra=(), opts=()):
    config, trainer_opts, _ = TRAINERS[trainer]
    return ["--root", str(data_root), "--seed", "1", "--trainer", trainer,
            "--dataset-config-file", SYNTHETIC_YAML, "--config-file", str(ROOT / config),
            "--output-dir", str(out_dir), *extra, *TINY, *trainer_opts,
            "MODEL.BACKBONE.WEIGHTS_PATH", str(weights), *opts]


@pytest.fixture(scope="module")
def port_checkpoints(tmp_path_factory, data_root, weights):
    """One epoch of the port's MaPLe and CoOp (a context of 4 tokens for each
    of Synthetic's 4 classes) through its command line; the checkpoints'
    paths."""
    out = tmp_path_factory.mktemp("runs")
    paths = {}
    for trainer in ("MaPLe", "CoOp"):
        _port_main(_argv(trainer, out / trainer, data_root, weights,
                         opts=("OPTIM.MAX_EPOCH", "1")))
        paths[trainer] = out / trainer / TRAINERS[trainer][2] / "model.pth.tar-1"
        assert paths[trainer].exists()
    return paths


# -- interpret_prompts ------------------------------------------------------


def test_nearest_words_matches_jax():
    r = np.random.default_rng(0)
    emb = r.standard_normal((50, 16)).astype(np.float32)
    ctx = r.standard_normal((3, 16)).astype(np.float32)
    tok = SimpleNamespace(decoder={i: f"word{i}" for i in range(0, 50, 2)})
    got = port_interpret.nearest_words(ctx, emb, tok, topk=4)
    assert got == jax_interpret.nearest_words(ctx, emb, tok, topk=4)
    assert len(got) == 3 and all(len(words) == 4 for words in got)
    assert any(w.startswith("<") for words in got for w, _ in words)  # odd ids: no word


@pytest.mark.parametrize("trainer", ["MaPLe", "CoOp"])
def test_interpret_prompts_prints_the_jax_lines(trainer, port_checkpoints, weights,
                                                monkeypatch, capsys):
    """``main`` of both tools on the port's checkpoint prints the same lines;
    CoOp's class-specific ctx is averaged over the classes."""
    model = SimpleNamespace(BACKBONE=SimpleNamespace(NAME="Tiny", WEIGHTS_PATH=str(weights)))
    monkeypatch.setattr(port_interpret, "load_clip_backbone",
                        lambda _: port_params.load_clip_backbone(model))
    monkeypatch.setattr(jax_interpret, "load_clip_backbone",
                        lambda _: jax_params.load_clip_backbone(model))
    argv = [str(port_checkpoints[trainer]), "--topk", "3", "--backbone", "Tiny"]
    monkeypatch.setattr(sys, "argv", ["interpret_prompts.py", *argv])
    jax_interpret.main()
    want = capsys.readouterr().out
    port_interpret.main(argv)
    got = capsys.readouterr().out
    assert got == want
    d = port_params.BACKBONE_CONFIGS["Tiny"].transformer_width
    key, shape = ("prompt_learner.ctx", (2, d)) if trainer == "MaPLe" else ("ctx", (4, d))
    assert f"=== {key} (shape {shape}) ===" in got  # CoOp: (4 classes, 4, d) averaged
    assert got.count("nearest: ") == shape[0]


# -- lpclip: feat_extractor and linear_probe -----------------------------------


def _feat_args(tmp_path, out, data_root, weights, split):
    cfg_file = tmp_path / "tiny.yaml"
    cfg_file.write_text(
        f"MODEL:\n  BACKBONE:\n    NAME: 'Tiny'\n    WEIGHTS_PATH: '{weights}'\n"
        "INPUT:\n  SIZE: [32, 32]\n  CANVAS_SIZE: 40\n  PIPELINE: 'host'\n"
        "DATALOADER:\n  TRAIN_X:\n    BATCH_SIZE: 6\n")
    return SimpleNamespace(root=str(data_root), output_dir=str(out), config_file=str(cfg_file),
                           dataset_config_file=SYNTHETIC_YAML, backbone="", split=split,
                           num_shots=-1, seed=1)


def test_feat_extractor_matches_jax_and_feeds_the_linear_probe(tmp_path, data_root, weights,
                                                              monkeypatch, capsys):
    """The port's ``{split}.npz`` against the JAX tool's on the test split:
    labels equal, each feature row within 1e-5 relative (L2) in fp32, the
    same arrays and dtypes in the file. Then the port's three splits through
    ``linear_probe.py``'s ``main`` as it is."""
    identity = lambda params, *a, **k: params  # noqa: E731 - fp32 weights in both packages
    monkeypatch.setattr(port_params, "apply_dtype_policy", identity)
    monkeypatch.setattr(jax_params, "apply_dtype_policy", identity)
    monkeypatch.setattr(sys, "stdout", sys.stdout)  # both tools tee it into log.txt
    monkeypatch.setenv("FMM_TPU_PLATFORM", "cpu")

    port_out, jax_out = tmp_path / "port", tmp_path / "jax"
    jax_feat.main(_feat_args(tmp_path, jax_out, data_root, weights, "test"))
    for split in ("train", "val", "test"):
        stats = port_feat.main(_feat_args(tmp_path, port_out, data_root, weights, split))
        assert stats["images"] > 0 and stats["batches"] == -(-stats["images"] // 6)
        assert 0 <= stats["loader_wait_seconds"] <= stats["seconds"]

    want = np.load(jax_out / "Synthetic" / "test.npz")
    got = np.load(port_out / "Synthetic" / "test.npz")
    assert sorted(got.files) == sorted(want.files) == ["feature_list", "label_list"]
    for name in got.files:
        assert got[name].dtype == want[name].dtype and got[name].shape == want[name].shape
    np.testing.assert_array_equal(got["label_list"], want["label_list"])
    f, w = got["feature_list"], want["feature_list"]
    assert f.shape == (16, port_params.BACKBONE_CONFIGS["Tiny"].embed_dim)
    rel = np.linalg.norm(f - w, axis=1) / np.linalg.norm(w, axis=1)
    assert rel.max() <= FEATURE_RTOL, rel.max()

    monkeypatch.chdir(tmp_path)  # the probe writes report/ into the working directory
    monkeypatch.setattr(sys, "argv", ["linear_probe.py", "--dataset", "Synthetic",
                                      "--num_step", "1", "--num_run", "1",
                                      "--feature_dir", str(port_out)])
    capsys.readouterr()
    linear_probe.main()
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "-shot:" in ln]
    assert [ln.split()[1] for ln in lines] == ["1-shot:", "2-shot:", "4-shot:", "8-shot:",
                                               "16-shot:"]
    assert (tmp_path / "report" / "Synthetic.txt").read_text().splitlines() == lines


# -- convert_reference_checkpoint --------------------------------------------


def _reference_state_dict(trainer, flat, rng):
    """A reference-named (PyTorch / Dassl) state dict for the port trainer
    whose flat state is ``flat``, each tensor seeded."""
    def rand(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    if trainer == "MaPLe":
        new = {k: rand(v.shape).numpy() for k, v in flat.items()}
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in converter.export_maple(new, skipped=[]).items()}
    pl = {k.removeprefix("prompt_learner."): v for k, v in flat.items()}
    if trainer in ("CoOp", "CoCoOp"):
        sd = {"ctx": rand(pl["ctx"].shape), "token_prefix": rand(pl["token_prefix"].shape),
              "token_suffix": rand(pl["token_suffix"].shape)}
        if trainer == "CoCoOp":
            for lin in ("linear1", "linear2"):
                sd[f"meta_net.{lin}.weight"] = rand(pl[f"meta_net.{lin}.w"].shape[::-1])
                sd[f"meta_net.{lin}.bias"] = rand(pl[f"meta_net.{lin}.b"].shape)
        return sd
    # IVLP and VPT: the vision prompts under the reference's VPT names (the
    # shallow one on the tower, the deep ones in the blocks they enter)
    sd = {"image_encoder.VPT": rand(flat["vpt.shallow"].shape)}
    deep = sorted(k for k in flat if k.startswith("vpt.deep."))
    for j, k in enumerate(deep):
        sd[f"image_encoder.transformer.resblocks.{j + 1}.VPT_shallow"] = rand(flat[k].shape)
    if trainer == "IVLP":
        sd["ctx"] = rand(pl["ctx"].shape)
        for k in (k for k in pl if k.startswith("deep_text.")):
            sd[k] = rand(pl[k].shape)
    return sd


def _convert(src, dst, trainer, reverse=False, monkeypatch=None):
    argv = ["convert_reference_checkpoint.py", str(src), str(dst), "--trainer", trainer]
    monkeypatch.setattr(sys, "argv", argv + (["--reverse"] if reverse else []))
    converter.main()


@pytest.mark.parametrize("trainer", ["MaPLe", "CoOp", "CoCoOp", "IVLP", "VPT"])
def test_converted_reference_checkpoint_loads_into_the_port(trainer, tmp_path, data_root,
                                                            weights, monkeypatch):
    """The converter's pickle is read by the port's ``load_checkpoint`` and
    its trainer's ``--eval-only``: every converted name of MaPLe, IVLP and VPT
    lands in the trainer's state with the converted values. CoOp and CoCoOp
    keep theirs unchanged, as the JAX package's trainers do: the converter
    writes ``prompt_learner.ctx`` where both packages' CoOp checkpoints hold
    ``ctx`` (a fault of the JAX tool, pinned below)."""
    _, _, model_name = TRAINERS[trainer]
    init = _port_main(_argv(trainer, tmp_path / "init", data_root, weights, ("--eval-only",)))
    before = {k: np.asarray(v) for k, v in
              flatten(init._models[model_name]["get"]()["state_dict"]).items()}
    rng = np.random.default_rng(sorted(TRAINERS).index(trainer))
    ref = _reference_state_dict(trainer, before, rng)
    src = tmp_path / "reference" / "model.pth.tar-1"
    src.parent.mkdir()
    torch.save({"epoch": 1, "state_dict": ref}, src)
    dst = tmp_path / "converted" / model_name / "model.pth.tar-1"
    _convert(src, dst, trainer, monkeypatch=monkeypatch)

    converted = load_checkpoint(str(dst))
    assert converted["epoch"] == 1
    flat = converted["state_dict"]
    assert flat and all(isinstance(v, np.ndarray) for v in flat.values())

    loaded = _port_main(_argv(trainer, tmp_path / "eval", data_root, weights,
                              ("--eval-only", "--model-dir", str(tmp_path / "converted"),
                               "--load-epoch", "1")))
    after = {k: np.asarray(v) for k, v in
             flatten(loaded._models[model_name]["get"]()["state_dict"]).items()}
    lands = {k for k in flat if k in after}
    if trainer in ("CoOp", "CoCoOp"):
        assert not lands and set(flat) <= {f"prompt_learner.{k}" for k in before}
        for k in after:
            np.testing.assert_array_equal(after[k], before[k], err_msg=k)
        return
    dropped = {"token_prefix", "token_suffix"}
    assert lands == set(flat) - dropped and lands, sorted(set(flat) - lands)
    for k in lands:
        np.testing.assert_array_equal(after[k], flat[k].astype(after[k].dtype), err_msg=k)


def test_jax_tool_converts_coop_ctx_under_a_name_coop_does_not_read():
    """The fault the CoOp / CoCoOp case works around: the converter names the
    reference's ``ctx`` ``prompt_learner.ctx``; the JAX package's CoOp reads
    its state relative to the prompt learner (``ctx``) and ignores the name."""
    flat = converter.convert_prompt_learner_only({"ctx": torch.ones(2, 4)}, "CoOp")
    assert set(flat) == {"prompt_learner.ctx"}
    tree = {"ctx": np.zeros((2, 4), np.float32)}
    new, used = jax_unflatten_into(tree, flat, strict_shapes=True)
    assert not used and not np.asarray(new["ctx"]).any()


def test_reverse_export_reads_a_port_checkpoint(port_checkpoints, tmp_path, monkeypatch):
    """``--reverse`` on the port's MaPLe checkpoint writes a reference-named
    torch checkpoint whose forward conversion gives back the port's tensors
    (the caption branch has no reference name and is reported as skipped)."""
    dst = tmp_path / "reference" / "model.pth.tar-1"
    _convert(port_checkpoints["MaPLe"], dst, "MaPLe", reverse=True, monkeypatch=monkeypatch)
    ref = torch.load(dst, map_location="cpu", weights_only=False)
    assert ref["epoch"] == 1
    assert "prompt_learner.ctx" in ref["state_dict"]
    back = converter.convert_maple(ref["state_dict"])
    ours = load_checkpoint(str(port_checkpoints["MaPLe"]))["state_dict"]
    assert back and set(back) <= set(ours)
    for k, v in back.items():
        np.testing.assert_array_equal(v, np.asarray(ours[k], np.float32), err_msg=k)


# -- captiongen --placeholder -----------------------------------------------


@pytest.mark.parametrize("name", ["PatternNet", "Ucmerced", "EuroSAT"])
def test_captiongen_placeholder_tree_is_read_by_the_port(name, tmp_path, monkeypatch):
    """``captiongen.py --placeholder`` over a seeded stand-in's images writes
    the caption tree the port's reader takes: each item's caption is the
    template of its folder's name."""
    image_dir = write_seeded_tree(str(tmp_path), name, per_class=4, size=8)
    caption_dir = tmp_path / LAYOUTS[name][1]
    for txt in caption_dir.rglob("*.txt"):
        txt.unlink()
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    captiongen.generate_placeholder(image_dir, str(caption_dir))
    cfg = get_cfg_default()
    cfg.DATASET.ROOT = str(tmp_path)
    cfg.DATASET.NAME = name
    cfg.DATASET.NUM_SHOTS = -1
    dataset = build_dataset(cfg)
    items = dataset.train_x + dataset.val + dataset.test
    assert len(items) == 4 * len(LAYOUTS[name][2])
    for item in items:
        folder = Path(item.impath).parent.name
        assert item.caption == f"a photo of a {folder.replace('_', ' ')}", item.impath
