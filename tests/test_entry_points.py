"""Measurement entry points refuse to run without a GPU."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import bench  # noqa: E402
import chip_smoke  # noqa: E402


def test_bench_requires_gpu():
    with pytest.raises(SystemExit, match="no GPU"):
        bench.require_gpu()


def test_bench_rejects_unknown_scene():
    with pytest.raises(ValueError, match="unknown scene"):
        bench.build_scene("teapot")


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_chip_smoke_without_gpu_exits_nonzero(argv, capsys):
    assert chip_smoke.main(argv) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out
