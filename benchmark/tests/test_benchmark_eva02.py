"""The cells added with EVA02-CLIP and the federated kind, on the CPU at tiny
sizes: the ``eva02_clip`` architecture through the train kind (the port's EVA
route on its plain steps against ``reference/eva02.py``), the ``fed`` kind
with four CPU clients (its ``fedavg_gap`` catching a client left out of the
exchange), and the new readers on synthetic traces."""

import json

import pytest
import torch

from benchmark import control, harness, pieces
from benchmark.tests.test_benchmark_harness import SEED, run_main
from benchmark.tests.test_benchmark_spans import MARK_S, Timeline
from benchmark.tests.tiny import REPO, load, make_root, write
from federated_multi_modal_tpu_torch.models.params import EvaCLIPConfig

# the tiny programs' bfloat16 readings on the CPU sit below these (the full
# sizes' limits are in benchmark/limits/)
TINY_EVA_LIMITS = {"grad_gap": 0.2, "change_gap": 0.2}
TINY_FED_LIMITS = {"grad_gap": 0.06, "change_gap": 0.06, "fedavg_gap": 1e-5}


def _add_cell(bench, name, config, traffic, like):
    bench["workloads"].append({"name": name, "config": config, "traffic": traffic, "chips":
                               4 if "fed" in name else 1, "why": "a CPU-sized cell for tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", []):
            m["workloads"].append(name)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = make_root(tmp_path_factory.mktemp("root"))
    bench = harness.load_benchmark(root)
    cfg = json.loads((REPO / "benchmark/configs/maple_eva02_l14.json").read_text())
    cfg.update(name="tiny_eva", embed_dim=64, image_resolution=48, vision_layers=3,
               vision_width=128, vision_patch_size=8, vision_mlp_width=341,
               vision_pt_hw_seq_len=6, transformer_width=128, transformer_heads=2,
               transformer_layers=2, n_classes=4)
    cfg["maple"] = dict(cfg["maple"], prompt_depth=3)
    write(root / "benchmark/configs/tiny_eva.json", cfg)
    bench["configs"].append({"name": "tiny_eva", "source": "tests", "reduced": [],
                             "file": "benchmark/configs/tiny_eva.json", "why": "tests"})
    train = json.loads((REPO / "benchmark/traffic/train_rrc_b480.json").read_text())
    write(root / "benchmark/traffic/tiny_eva_train.json", dict(train, batch=4, canvas=56))
    write(root / "benchmark/limits/tiny_eva_train.json",
          {k: {"limit": v} for k, v in TINY_EVA_LIMITS.items()})
    _add_cell(bench, "tiny_eva_train", "tiny_eva", "tiny_eva_train", "maple_eva02_l14_train")
    fed = json.loads((REPO / "benchmark/traffic/fed4_rrc_b512.json").read_text())
    write(root / "benchmark/traffic/tiny_fed4.json", dict(fed, batch=4, canvas=40,
                                                         fedavg_every=2))
    write(root / "benchmark/limits/tiny_fed4.json",
          {k: {"limit": v} for k, v in TINY_FED_LIMITS.items()})
    _add_cell(bench, "tiny_fed4", "tiny", "tiny_fed4", "maple_b16_fed4")
    write(root / "BENCHMARK.json", bench)
    return root


def test_eva_cell_runs_through_the_train_kind_and_is_correct(root, monkeypatch):
    cfg, _ = load(root, "tiny_eva_train")
    assert cfg["architecture"] == "eva02_clip"
    arch = harness.architecture(root, cfg)
    assert {"state_dict", "prompt_learner", "system", "Reference", "crop", "grad_norm",
            "strict_fp32", "reference_rows", "train_step_flops", "eval_batch_flops",
            "attention_work", "gemm_work"} <= set(dir(arch))
    rc, lines, err = run_main(root, monkeypatch, "--workload", "tiny_eva_train", "--seed",
                              str(SEED), "--seconds", "0.3")
    line = json.loads(lines[-1])
    assert rc == 0 and line["correct"] is True and line["attempted"] > 0, line["checks"]
    assert set(line["metrics"]) == {"train_images_per_s", "peak_mem_gib", "setup_s"}
    assert set(line["checks"]) == set(TINY_EVA_LIMITS)


def test_eva_weights_are_evas_layout_and_the_port_loads_them(root):
    cfg, mix = load(root, "tiny_eva_train")
    arch = harness.architecture(root, cfg)
    sd = arch.state_dict(cfg, SEED, torch.device("cpu"))
    assert torch.equal(sd["visual.blocks.1.mlp.w3.weight"],
                       arch.state_dict(cfg, SEED, torch.device("cpu"))["visual.blocks.1.mlp.w3.weight"])
    assert sd["visual.blocks.0.mlp.w1.weight"].shape == (341, 128)
    assert "visual.blocks.0.attn.k_bias" not in sd and "visual.blocks.0.attn.q_bias" in sd
    prog = arch.system.build(sd, arch.prompt_learner(cfg, True, SEED, torch.device("cpu")), cfg,
                             [f"class {i}" for i in range(4)], True, torch.device("cpu"))
    assert isinstance(prog["arch"], EvaCLIPConfig)
    assert prog["arch"].vision_mlp_width == 341
    # every trainable leaf of the port has a name of the reference's
    step, state = arch.system.train_step(prog, cfg, generator_inputs(mix, cfg), lambda: None)
    names = set(arch.system.trainable_flat(state))
    ref = arch.Reference(sd, arch.prompt_learner(cfg, True, SEED, torch.device("cpu")),
                         [f"class {i}" for i in range(4)], cfg, torch.device("cpu"))
    assert names == set(ref.trainable)


def generator_inputs(mix, cfg):
    from benchmark.traffic import generator

    return generator.make_inputs(mix, cfg["n_classes"], SEED, torch.device("cpu"))


def test_eva_counts_equal_clip_l14s_flops_to_two_hundredths_of_a_percent():
    arch = harness.architecture(REPO, json.loads(
        (REPO / "benchmark/configs/maple_eva02_l14.json").read_text()))
    cfg = json.loads((REPO / "benchmark/configs/maple_eva02_l14.json").read_text())
    l14 = json.loads((REPO / "benchmark/configs/maple_vit_l14.json").read_text())
    mix = json.loads((REPO / "benchmark/traffic/train_rrc_b480.json").read_text())
    from benchmark.counts import flops

    ratio = arch.train_step_flops(cfg, mix, 8) / flops.train_step_flops(l14, mix, 8)
    assert abs(ratio - 1) < 2e-4
    tagged = [o for o in arch.gemm_work(cfg, mix, 8) if o.get("part") == "swiglu"]
    # the gated product (2 H columns) and the gate's backward, which adds nothing
    assert tagged[0]["flops"] == 2.0 * 480 * 260 * 2 * 2730 * 1024 * 24
    assert tagged[1]["flops"] == tagged[1]["bytes"] == 0.0 and tagged[1]["part_bytes"] > 0


def test_fed_cell_runs_four_clients_and_is_correct(root, monkeypatch):
    rc, lines, err = run_main(root, monkeypatch, "--workload", "tiny_fed4", "--seed",
                              str(SEED), "--seconds", "0.3")
    line = json.loads(lines[-1])
    assert rc == 0 and line["correct"] is True, line["checks"]
    assert line["attempted"] % (4 * 4 * 2) == 0 and line["attempted"] > 0
    assert set(line["checks"]) == set(TINY_FED_LIMITS)
    assert line["device"]["count"] == 4


def test_fedavg_gap_catches_a_client_left_out(root):
    cfg, mix = load(root, "tiny_fed4")
    got = control.readings(root, cfg, mix, SEED, [torch.device("cpu")] * 4, True)
    assert got["program"]["fedavg_gap"] <= TINY_FED_LIMITS["fedavg_gap"]
    assert got["left_out"]["fedavg_gap"] > 100 * TINY_FED_LIMITS["fedavg_gap"]
    assert got["program"]["grad_gap"] <= TINY_FED_LIMITS["grad_gap"]


class _T:
    """A synthetic trace as the readers take it."""

    def __init__(self, per_device, steps, work=None, kind="train"):
        self.per_device, self.steps, self.kind = per_device, steps, kind
        self.kernels = [k for d in sorted(per_device) for k in per_device[d]]
        self.work = work or {}

    def kernel_seconds(self, group):
        from benchmark.devtrace import patterns

        pats = patterns(group)
        hits = [d for n, _, d in self.kernels if any(p.search(n) for p in pats)]
        return sum(hits) if hits else None


def _mark(sid: int, opens: bool) -> str:
    return f"void span_marker<{sid}, {'true' if opens else 'false'}>()"


def test_new_readers_read_a_synthetic_trace():
    tl = Timeline()
    # two steps, each with a vision_mlp span (id 15) of 3 ms of kernels inside the
    # tower (id 5) and its backward (id 17) of 5 ms
    for _ in range(2):
        for sid, opens, op in ((0, True, None), (5, True, None), (15, True, 3e-3),
                               (15, False, None), (5, False, None), (17, True, 5e-3),
                               (17, False, None), (0, False, None)):
            tl.op(_mark(sid, opens), MARK_S)
            if op == 3e-3:
                tl.op("void (anonymous namespace)::gemm_epilogue_kernel<0, 1029>(...)", op)
            elif op == 5e-3:
                tl.op("void (anonymous namespace)::layernorm_bwd_gate_kernel(...)", op)
    t = tl.trace("train", 2)
    mlp = pieces.load(REPO, "metrics", "vision_mlp_ms.train").read(t)
    assert mlp == pytest.approx(8.0)
    t = _T({0: list(tl.kernels)}, steps=2)
    t.work = {"gemm": [{"flops": 989e12 * 1e-3, "bytes": 0.0, "part": "swiglu"},
                       {"flops": 0.0, "bytes": 0.0, "part": "swiglu", "part_flops": 0.0,
                        "part_bytes": 3.35e12 * 2e-3},
                       {"flops": 1e15, "bytes": 0.0}]}
    roof = pieces.load(REPO, "metrics", "swiglu_roofline.train").read(t)
    # 3 ms of bound a step over 8 ms of the matched kernels a step
    assert roof == pytest.approx(100.0 * 3e-3 / 8e-3)
    # FedAvg on the home card inside its step, a replica's kernel on another
    fed = _T({0: [(_mark(0, True), 0.0, MARK_S), (_mark(16, True), 1e-3, MARK_S),
                  ("avg", 2e-3, 4e-3), (_mark(16, False), 7e-3, MARK_S),
                  (_mark(0, False), 8e-3, MARK_S)],
              1: [("gemm", 0.0, 5e-3)]}, steps=10)
    assert pieces.load(REPO, "metrics", "fedavg_ms.train").read(fed) == pytest.approx(
        1e3 * (7e-3 - (1e-3 + MARK_S)) / 10)
    none = _T({0: [("gemm", 0.0, 1e-3)]}, steps=10)
    for name in ("vision_mlp_ms.train", "swiglu_roofline.train", "fedavg_ms.train"):
        assert pieces.load(REPO, "metrics", name).read(none) is None
