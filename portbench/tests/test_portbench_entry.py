"""The command's refusals: no result without a CUDA device, or without the
program in the checkout."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

PKG = Path(__file__).resolve().parents[1]


def _run(cwd):
    return subprocess.run([sys.executable, "-m", "portbench", "--workload", "qdm_month_tas.full150", "--seed", "2147483700",
                           "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True, timeout=300)


def _has_result(stdout):
    lines = stdout.strip().splitlines()
    try:
        return bool(lines) and "metrics" in json.loads(lines[-1])
    except json.JSONDecodeError:
        return False


def test_no_cuda_device_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run(PKG.parent)
    assert out.returncode != 0 and not _has_result(out.stdout)
    assert "no CUDA device" in out.stderr


def test_benchmark_files_alone_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copy(PKG.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(PKG, tmp_path / PKG.name, ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and not _has_result(out.stdout)
