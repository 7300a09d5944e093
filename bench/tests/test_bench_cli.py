"""The command's refusals, as processes: no result and a non-zero exit
without a CUDA card, and in a directory that holds only ``BENCHMARK.json``
and the benchmark's files (no program)."""
import shutil
import subprocess
import sys

import pytest
import torch

from bench import harness


def run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "train-sage-products",
         "--seed", "2147483659", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1",
             "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = run(harness.ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = run(tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
