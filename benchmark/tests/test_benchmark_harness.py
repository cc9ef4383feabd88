"""The harness on the CPU at Tiny size: the last line, the lookup of cells,
configurations and metrics by name, the frozen FLOP count, and the imports
the benchmark may not make."""

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

FORBIDDEN = {"jax", "jaxlib", "flax", "federated_multi_modal_tpu"}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("root"))


def run_main(root, monkeypatch, *argv):
    """``harness.main`` on the CPU: ``(exit code, stdout lines, stderr)``."""
    monkeypatch.setattr(harness, "require_devices", lambda chips: torch.device("cpu"))
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
        assert cfg["name"] == w["config"] and mix["kind"] in ("train", "eval")
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
