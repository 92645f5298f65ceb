"""Tests for the card: ``python3 -m pytest benchmark/tests -m chip`` on the
chip.  Each skips where there is no CUDA device."""

import json
import subprocess
import sys

import pytest

from benchmark.harness import compare, spec
from benchmark.tests.test_bench_control import control_readings

WORKLOADS = ["cube_1080p.present", "cube_1080p.sequence"]


@pytest.mark.chip
@pytest.mark.parametrize("workload", WORKLOADS + ["big_mesh_4k_msaa4.sequence"])
@pytest.mark.parametrize("seed", [2**31 + 201, 2**31 + 202, 2**31 + 203])
def test_control_fails_at_the_cells_own_size(bench, cuda_device, workload, seed):
    limits = spec.limits(workload)
    sound, control = control_readings(bench, workload, seed, {}, device=cuda_device)
    assert compare.judge(sound, limits)[0], sound
    assert not compare.judge(control, limits)[0], control


@pytest.mark.chip
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_short_run_on_the_card_is_correct(cuda_device, workload):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload, "--seed", str(2**31 + 301),
                          "--seconds", "2", "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert set(line["metrics"]) == {m["name"] for m in spec.metrics(spec.load(), workload, False)}
