"""The harness on the CPU at Tiny size: the last line, the lookup of cells,
configurations and metrics by name, a cell, an architecture and a kind of
loop added by new files alone, the frozen FLOP count, and the imports the
benchmark may not make."""

import ast
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark.counts import flops
from benchmark.tests.tiny import REPO, load, make_root, write
from benchmark.traffic.generator import load_mix

FORBIDDEN = {"jax", "jaxlib", "flax", "federated_multi_modal_tpu"}
TESTS = Path(__file__).resolve().parent
SEED = 2 ** 31 + 3


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("root"))


def run_main(root, monkeypatch, *argv):
    """``harness.main`` on the CPU: ``(exit code, stdout lines, stderr)``."""
    monkeypatch.setattr(harness, "require_devices", lambda chips: [torch.device("cpu")] * chips)
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = harness.main(list(argv), root, 0.0)
    return rc, out.getvalue().splitlines(), err.getvalue()


@pytest.mark.parametrize("cell,trace", [("tiny_train", 0), ("tiny_eval", 0),
                                        ("tiny_train", 1)])
def test_last_line_has_the_contract_keys(tiny, monkeypatch, cell, trace):
    rc, lines, err = run_main(tiny, monkeypatch, "--workload", cell, "--seed",
                              str(2 ** 31 + 99), "--seconds", "0.5", "--trace", str(trace))
    assert rc == 0
    line = json.loads(lines[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    bench = harness.load_benchmark(tiny)
    want = {m["name"] for m in harness.reported_metrics(bench, cell, bool(trace))}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # no device ran: the trace's readers find nothing and print nothing
        assert line["metrics"] == {}
    else:
        assert set(line["metrics"]) == want
        assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split(":")[0] for t in tail] == [f"check {n}" for n in line["checks"]]


def test_no_result_without_a_card(tiny, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = harness.main(["--workload", "tiny_train", "--seed", "1", "--seconds", "1"],
                          tiny, 0.0)
    assert rc != 0 and out.getvalue() == ""


def test_no_result_without_the_program(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's files
    fails: the system under test is not there."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import os, sys, torch; torch.cuda.is_available = lambda: True; "
            "torch.cuda.device_count = lambda: 1; "
            "sys.argv = ['benchmark/run.py', '--workload', 'maple_b16_eval', '--seed', '1', "
            "'--seconds', '1']; path = os.path.abspath('benchmark/run.py'); "
            "exec(compile(open(path).read(), path, 'exec'), "
            "{'__file__': path, '__name__': '__main__'})")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
        if p and Path(p).resolve() != REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode != 0 and res.stdout == ""
    assert "federated_multi_modal_tpu_torch" in res.stderr


def test_pieces_are_found_by_name(tiny):
    bench = harness.load_benchmark(tiny)
    for w in bench["workloads"]:
        cfg, mix = load(tiny, w["name"])
        assert cfg["name"] == w["config"]
        assert (tiny / "benchmark" / "kinds" / f"{mix['kind']}.py").exists()
        arch = cfg.get("architecture", "clip_vit")
        assert (tiny / "benchmark" / "architectures" / f"{arch}.py").exists()
        assert (tiny / "benchmark" / "limits" / f"{w['name']}.json").exists()
    for m in bench["per_layer"]:
        assert (tiny / "benchmark" / "metrics" / f"{m['name']}.py").exists()
    for c in bench["configs"]:
        assert (tiny / c["file"]).exists()


def _digests(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "benchmark").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_needs_new_files_only(tmp_path, monkeypatch):
    root = make_root(tmp_path)
    before = _digests(root)
    bench = harness.load_benchmark(root)
    mix = json.loads((root / "benchmark/traffic/tiny_eval.json").read_text())
    write(root / "benchmark/traffic/tiny_eval_b6.json", dict(mix, batch=6, roll=2))
    write(root / "benchmark/limits/tiny_eval_b6.json",
          json.loads((root / "benchmark/limits/tiny_eval.json").read_text()))
    bench["workloads"].append({"name": "tiny_eval_b6", "config": "tiny",
                               "traffic": "tiny_eval_b6", "chips": 1, "why": "added"})
    for m in bench["end_to_end"]:
        if "tiny_eval" in m.get("workloads", []):
            m["workloads"].append("tiny_eval_b6")
    write(root / "BENCHMARK.json", bench)
    rc, lines, _ = run_main(root, monkeypatch, "--workload", "tiny_eval_b6", "--seed", "4",
                            "--seconds", "0.5")
    line = json.loads(lines[-1])
    assert rc == 0 and line["correct"] and line["attempted"] % 6 == 0
    assert "eval_images_per_s" in line["metrics"]
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before


def add_cell(bench: dict, name: str, config: str, traffic: str, like: str = None) -> None:
    """A one-card cell; it reports each end-to-end metric that ``like``
    reports."""
    bench["workloads"].append({"name": name, "config": config, "traffic": traffic,
                               "chips": 1, "why": "added"})
    for m in bench["end_to_end"]:
        if like in m.get("workloads", []):
            m["workloads"].append(name)


TOY_OPTIM = {"lr": 0.05, "momentum": 0.9, "weight_decay": 5e-4, "clip_norm": 1.0}
TOY_LIMITS = {"toy_train": {"grad_gap": 1e-4, "change_gap": 1e-4},
              "toy_eval": {"logit_gap": 1e-4}}


def test_a_new_architecture_needs_new_files_only(tmp_path, monkeypatch):
    """A configuration naming an architecture that is not CLIP's (a
    two-layer perceptron, its own system and reference) runs a train and an
    eval cell through the existing kinds."""
    root = make_root(tmp_path)
    before = _digests(root)
    shutil.copy(TESTS / "toy_architecture.py", root / "benchmark/architectures/toy.py")
    write(root / "benchmark/configs/toy.json",
          {"name": "toy", "architecture": "toy", "image_resolution": 8, "hidden": 16,
           "n_classes": 4, "classnames": "class {i}", "optim": TOY_OPTIM})
    bench = harness.load_benchmark(root)
    bench["configs"].append({"name": "toy", "source": "tests", "reduced": [],
                             "file": "benchmark/configs/toy.json", "why": "tests"})
    for cell, like in (("toy_train", "tiny_train"), ("toy_eval", "tiny_eval")):
        mix = json.loads((root / f"benchmark/traffic/{like}.json").read_text())
        write(root / f"benchmark/traffic/{cell}.json", dict(mix, captions=False))
        write(root / f"benchmark/limits/{cell}.json",
              {k: {"limit": v} for k, v in TOY_LIMITS[cell].items()})
        add_cell(bench, cell, "toy", cell, like)
    write(root / "BENCHMARK.json", bench)
    for cell, rate in (("toy_train", "train_images_per_s"), ("toy_eval", "eval_images_per_s")):
        rc, lines, _ = run_main(root, monkeypatch, "--workload", cell, "--seed", str(SEED),
                                "--seconds", "0.3")
        line = json.loads(lines[-1])
        assert rc == 0 and line["correct"] is True and line["attempted"] > 0, line["checks"]
        assert set(line["metrics"]) == {rate, "peak_mem_gib", "setup_s"}
        assert set(line["checks"]) == set(TOY_LIMITS[cell])
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_new_kind_needs_new_files_only(tmp_path, monkeypatch):
    """A mix naming a kind added as a file runs, with an end-to-end metric
    of its own, and its readings are found by name."""
    from benchmark import control

    root = make_root(tmp_path)
    before = _digests(root)
    shutil.copy(TESTS / "toy_kind.py", root / "benchmark/kinds/products.py")
    write(root / "benchmark/traffic/products_n16.json", {"kind": "products", "n": 16})
    write(root / "benchmark/limits/tiny_products.json", {"product_gap": {"limit": 1e-3}})
    bench = harness.load_benchmark(root)
    add_cell(bench, "tiny_products", "tiny", "products_n16")
    bench["end_to_end"].insert(0, {"name": "products_per_s", "unit": "products/s",
                                   "better": "higher", "bound": 0.01, "source": "host_clock",
                                   "workloads": ["tiny_products"]})
    write(root / "BENCHMARK.json", bench)
    rc, lines, _ = run_main(root, monkeypatch, "--workload", "tiny_products", "--seed",
                            str(SEED), "--seconds", "0.3")
    line = json.loads(lines[-1])
    assert rc == 0 and line["correct"] is True and line["attempted"] > 0
    assert set(line["metrics"]) == {"products_per_s", "peak_mem_gib", "setup_s"}
    cfg, mix = load(root, "tiny_products")
    got = control.readings(root, cfg, mix, SEED, [torch.device("cpu")], False)
    assert got["program"]["product_gap"] <= 1e-3
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_mix_naming_a_kind_without_a_file_raises(tmp_path):
    root = make_root(tmp_path)
    write(root / "benchmark/traffic/nowhere.json", {"kind": "nowhere", "batch": 4})
    with pytest.raises(ValueError, match=r"'nowhere'.*known: \['eval', 'train'\]"):
        load_mix(root, "nowhere")
    write(root / "benchmark/traffic/helpers.json", {"kind": "common", "batch": 4})
    with pytest.raises(ValueError, match="known"):
        load_mix(root, "helpers")


def test_frozen_flop_count_equals_the_programs():
    from benchmark.reference.model import ClassPrompts

    from federated_multi_modal_tpu_torch.flagship import estimate_train_step_flops
    from federated_multi_modal_tpu_torch.models.params import BACKBONE_CONFIGS

    TEXT_LEN = ClassPrompts("a photo of a", [f"class {i}" for i in range(1000)], 2).text_len
    for config, traffic, backbone in (("maple_vit_b16", "train_rrc_b512", "ViT-B/16"),
                                      ("maple_vit_l14", "train_rrc_b480", "ViT-L/14")):
        cfg = json.loads((REPO / f"benchmark/configs/{config}.json").read_text())
        mix = json.loads((REPO / f"benchmark/traffic/{traffic}.json").read_text())
        want = estimate_train_step_flops(BACKBONE_CONFIGS[backbone], mix["batch"],
                                         cfg["n_classes"], TEXT_LEN, use_captions=True,
                                         n_vis_ctx=2)
        assert flops.train_step_flops(cfg, mix, TEXT_LEN) == want
    b16 = json.loads((REPO / "benchmark/configs/maple_vit_b16.json").read_text())
    b512 = json.loads((REPO / "benchmark/traffic/train_rrc_b512.json").read_text())
    assert round(flops.train_step_flops(b16, b512, TEXT_LEN) / 1e12, 2) == 42.29
    # the configurations name no architecture: clip_vit's counts are the frozen ones
    for config in ("maple_vit_b16", "maple_vit_l14"):
        cfg = json.loads((REPO / f"benchmark/configs/{config}.json").read_text())
        arch = harness.architecture(REPO, cfg)
        assert Path(arch.__file__).name == "clip_vit.py"
        for traffic in ("train_rrc_b512", "train_rrc_b480", "eval_center_b512"):
            mix = json.loads((REPO / f"benchmark/traffic/{traffic}.json").read_text())
            for count in ("train_step_flops", "eval_batch_flops", "attention_work",
                          "gemm_work"):
                assert (getattr(arch, count)(cfg, mix, TEXT_LEN)
                        == getattr(flops, count)(cfg, mix, TEXT_LEN)), (config, traffic, count)


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_anywhere_and_no_port_in_the_reference():
    files = [p for p in (REPO / "benchmark").rglob("*.py") if "__pycache__" not in p.parts]
    assert files
    for p in files:
        found = _imports(p) & FORBIDDEN
        assert not found, f"{p}: {found}"
    for p in (REPO / "benchmark" / "reference").rglob("*.py"):
        assert "federated_multi_modal_tpu_torch" not in _imports(p), p
