"""The plain reference held against the port's plain path at Tiny size.

The port runs in float32 here (its weights converted without the bfloat16
policy, attention on its ``"xla"`` route), so the two should agree to
float32 rounding: the loss, every trainable leaf's gradient, the eval
logits. The crops and the class prompts' tokens are held to the port's
own.
"""

import numpy as np
import pytest
import torch

from benchmark.reference import model as R
from benchmark.reference import tokens
from benchmark.system import maple as S
from benchmark.tests.tiny import load, make_root
from benchmark.traffic import generator, weights


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("root"))


@pytest.fixture
def fp32_port(monkeypatch):
    """The port's program in float32 on its plain attention route."""
    from federated_multi_modal_tpu_torch.ops import primitives

    convert = S.convert_torch_state_dict
    monkeypatch.setattr(S, "convert_torch_state_dict",
                        lambda sd, arch: convert(sd, arch, dtype_policy=False))
    saved = primitives.attention_impl()
    primitives.set_attention_impl("xla")
    yield
    primitives.set_attention_impl(saved)


def _setup(tiny, cell, seed, captions):
    cfg, mix = load(tiny, cell)
    cpu = torch.device("cpu")
    sd = weights.openai_state_dict(cfg, seed, cpu)
    pl = weights.prompt_learner(cfg, captions, seed, cpu)
    inputs = generator.make_inputs(mix, cfg["n_classes"], seed, cpu)
    names = [cfg["classnames"].format(i=i) for i in range(cfg["n_classes"])]
    return cfg, mix, sd, pl, inputs, names


def _port_layout(name, ref_grad):
    """OpenAI keeps linear weights output-major, the port input-major."""
    if ref_grad.ndim == 2 and not name.startswith("prompt_learner."):
        return ref_grad.T
    return ref_grad


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 7])
def test_loss_and_gradients_match_the_port(tiny, fp32_port, seed):
    from federated_multi_modal_tpu_torch.engine.trainer import loss_grads_and_aux
    from federated_multi_modal_tpu_torch.engine.tree import flatten
    from federated_multi_modal_tpu_torch.ops.preprocess import crop_resize_flip_normalize

    cfg, mix, sd, pl, inputs, names = _setup(tiny, "tiny_train", seed, True)
    prog = S.build(sd, pl, cfg, names, True, torch.device("cpu"))
    boxes, flips = generator.random_resized_boxes(
        generator.box_generator(seed, torch.device("cpu")), mix)
    img = crop_resize_flip_normalize(inputs["canvas"], boxes, flips, cfg["image_resolution"])
    batch = {"image": img, "label": inputs["labels"], "caption_tokens": inputs["captions"]}
    loss, grads, _ = loss_grads_and_aux(prog["loss_fn"], prog["trainable"], prog["frozen"],
                                        batch)

    ref = R.MaPLe(sd, pl, names, cfg, torch.device("cpu"))
    ref_loss, ref_grads = ref.loss_and_grads(img.float().permute(0, 3, 1, 2).contiguous(),
                                             inputs["labels"], inputs["captions"], rows=3)
    assert abs(float(loss) - ref_loss) <= 1e-5 * abs(ref_loss)
    port = {S.ref_name(k): v for k, v in flatten(grads).items()}
    assert set(port) == set(ref_grads)
    for name, g in port.items():
        want = _port_layout(name, ref_grads[name])
        assert torch.allclose(g, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()) + 1e-12), name


def test_eval_logits_match_the_port(tiny, fp32_port):
    from federated_multi_modal_tpu_torch.ops.preprocess import crop_resize_flip_normalize

    cfg, mix, sd, pl, inputs, names = _setup(tiny, "tiny_eval", 11, False)
    prog = S.build(sd, pl, cfg, names, False, torch.device("cpu"))
    boxes, flips = generator.center_boxes(mix, torch.device("cpu"))
    img = crop_resize_flip_normalize(inputs["canvas"], boxes, flips, cfg["image_resolution"])
    prep = prog["eval_prepare_fn"](prog["trainable"], prog["frozen"])
    got = prog["eval_apply_fn"](prog["trainable"], prog["frozen"], img, prep)
    ref = R.MaPLe(sd, pl, names, cfg, torch.device("cpu"))
    want = ref.logits(img.float().permute(0, 3, 1, 2).contiguous(), rows=3)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-4)


def test_crops_match_the_port_to_bfloat16():
    from federated_multi_modal_tpu_torch.ops.preprocess import crop_resize_flip_normalize

    mix = {"batch": 6, "canvas": 40, "scale": [0.08, 1.0], "ratio": [0.75, 4 / 3],
           "flip": 0.5}
    cpu = torch.device("cpu")
    canvas = generator.make_inputs(dict(mix, kind="train"), 4, 5, cpu)["canvas"]
    boxes, flips = generator.random_resized_boxes(generator.box_generator(5, cpu), mix)
    got = crop_resize_flip_normalize(canvas, boxes, flips, 32).float()
    want = R.crop(canvas, boxes, flips, 32).permute(0, 2, 3, 1)
    # the port rounds its crops to bfloat16: 2**-8 of the largest magnitude
    assert float((got - want).abs().max()) <= 2 ** -8 * float(want.abs().max())


def test_class_prompt_tokens_match_the_port_tokenizer():
    from federated_multi_modal_tpu_torch.tokenizer import tokenize

    texts = ["a photo of a"] + [f"a photo of a class {i}." for i in range(1000)]
    np.testing.assert_array_equal(tokens.tokenize(texts), tokenize(texts).astype(np.int64))
