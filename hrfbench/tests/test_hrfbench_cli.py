"""The command's exits: no result without a card, without the program, or
for an unknown cell; and, on the card, every cell once untraced and once
traced (`python -m pytest -q -m cuda hrfbench/tests` there)."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from hrfbench import harness

SPEC = harness.load_spec()


def run(cwd, *args, timeout=600):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-m", "hrfbench.run", *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_no_result_without_the_program(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "hrfbench", ignore=shutil.ignore_patterns("cache", "__pycache__"))
    out = run(tmp_path, "--workload", "r4-proposal.train", "--seed", "1", "--seconds", "1")
    assert out.returncode != 0 and out.stdout == ""


def test_no_result_for_an_unknown_cell():
    out = run(harness.ROOT, "--workload", "no-such.cell", "--seed", "1", "--seconds", "1")
    assert out.returncode != 0 and out.stdout == ""


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = run(harness.ROOT, "--workload", "r4-proposal.train", "--seed", "1", "--seconds", "1")
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
@pytest.mark.parametrize("trace", ["0", "1"])
def test_each_cell_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = run(harness.ROOT, "--workload", cell, "--seed", str(2**31 + 2**30 + 17), "--seconds", "3", "--trace", trace)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(result)[-1] == "checks" and result["correct"] is True
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    section = "per_layer" if trace == "1" else "end_to_end"
    assert set(result["metrics"]) == {m["name"] for m in harness.cell_metrics(SPEC, cell, section)}
    if trace == "1":
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        for name, m in result["metrics"].items():
            if "roofline" in name or "mfu" in name:
                assert 0 < m["value"] <= 100, (name, m)
