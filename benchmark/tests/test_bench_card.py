"""The correctness control at each cell's own size, on the card: the
plain reference in float8 (for a training cell also on half of each
batch) put in the program's place fails at least one of the cell's
numbers on three seeds. On the card:

    python -m pytest -p no:cacheprovider -m cuda \
        benchmark/tests/test_bench_card.py
"""

from __future__ import annotations

import pytest
import torch

from benchmark import control, harness

SEEDS = (2147483011, 2147483012, 2147483013)


@pytest.mark.cuda
@pytest.mark.parametrize("cell,fault", [
    ("sd14_refine_b8", "fp8"), ("sd14_refine_b1_serve", "fp8"),
    ("train_b6", "fp8"), ("train_b6", "half_batch")])
def test_the_control_fails_the_cell_at_its_own_size(cell, fault):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's "
                    "own size")
    for seed in SEEDS:
        run = harness.load_run(cell, seed, 0.0, False, 0.0)
        got = control.readings(run, fault)
        assert any(got[k] > lim for k, lim in run.cell["limits"].items()), (
            seed, got)
