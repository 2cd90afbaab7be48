"""On the card, at each cell's own size: three seeds of the timed path within
the cell's limits, and the fp8 control outside them.

    python -m pytest benchmark/tests/test_bench_control_cuda.py -q

(skips without a CUDA device)."""

import json

import pytest

from benchmark import cells, check, control


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run the port's CUDA kernels")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["zeroscope_576w.video", "sd15.image"])
def test_control_fails_where_the_program_passes(cell, card, capsys):
    assert control.main(["--workload", cell, "--seeds", "31,32,33"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    limits = cells.load_workload(cell)["check"]["limits"]
    assert check.verdict(summary["program_max"], limits), summary
    assert any(summary["control_min"][n] > limits[n] for n in summary["control_min"]), summary
