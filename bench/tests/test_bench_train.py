"""The training driver end to end on the CPU at a tiny size: the program's
Trainer.fit against the plain model-centric reference."""
import time

import pytest

from bench.tests import tiny


@pytest.mark.parametrize("kind", ["sage", "gat"])
def test_train_run_is_correct(kind, tmp_path):
    cell = tiny.train_cell(kind, tmp_path)
    result, compared = cell.driver().run(
        cell, seed=2**31 + 11, seconds=0.2, trace=False, device="cpu",
        t_start=time.perf_counter())
    assert result["correct"], compared
    assert set(compared) == set(tiny.LOOSE)
    for c in compared.values():
        assert c["value"] < 1e-5
    m = result["metrics"]
    assert m["train_roots_per_s"]["value"] > 0
    assert m["setup_s"]["value"] > 0
