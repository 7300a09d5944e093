"""A run with the timed path broken underneath comes out not correct: the
whole driver on the CPU at a tiny size (the look for a card skipped), with
one fault planted in the program for each fault its cell can have."""
import time

import numpy as np
import pytest
import torch

from bench.tests import tiny


def _no_update(*args, **kwargs):
    """AdamW's group step left out: the step returns its state unchanged."""


def _half_the_batch(self, grads_g, denom):
    """The gradient of the first half of the shards only, as the mean over
    them: half of the batch left out."""
    half = grads_g[: len(grads_g) // 2]
    out = [g.clone() for g in half[0]]
    for g in half[1:]:
        torch._foreach_add_(out, g)
    return torch._foreach_div(out, denom / 2)


def _no_exchange(self, table_g, req_g):
    """The rows other shards send replaced by zeros: the exchange left out."""
    n, p, r = req_g.shape
    return torch.zeros((n, p, r, table_g.shape[-1]), dtype=table_g.dtype,
                       device=table_g.device)


def _stale_in_flight():
    """Every later iteration of an epoch dispatched on the device buffers
    of the epoch's first, as if the upload of a plan in flight landed in a
    buffer that was then reused: a fault only an epoch of more than one
    iteration can have."""
    from repro_torch.train.pipeline import PlanUploader
    commit = PlanUploader.commit

    def stale(self, plan):
        commit(self, plan)
        if plan.epoch_it[1] == 0:
            self.first_committed = plan.committed
        else:
            plan.committed = self.first_committed
    return stale


TRAIN_FAULTS = {
    "state_unchanged": ("repro_torch.optim.optimizers", "_adamw_group",
                        _no_update),
    "half_batch": ("repro_torch.core.distributed.EmulatedComm",
                   "grad_mean_global", _half_the_batch),
    "no_exchange": ("repro_torch.core.distributed.EmulatedComm",
                    "exchange_global", _no_exchange),
    "stale_in_flight": ("repro_torch.train.pipeline.PlanUploader", "commit",
                        None),
}


def _target(path: str):
    import importlib
    mod, _, attr = path.rpartition(".")
    try:
        return importlib.import_module(path)
    except ModuleNotFoundError:
        return getattr(importlib.import_module(mod), attr)


def _run(cell):
    return cell.driver().run(cell, seed=123456789, seconds=0.2, trace=False,
                             device="cpu", t_start=time.perf_counter())


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_train_fault_is_not_correct(fault, tmp_path, monkeypatch):
    where, name, fn = TRAIN_FAULTS[fault]
    fn = fn or _stale_in_flight()
    monkeypatch.setattr(_target(where), name, fn)
    result, compared = _run(tiny.train_cell("sage", tmp_path))
    assert not result["correct"], compared
    assert any(c["value"] > c["limit"] for c in compared.values())


def test_train_sound_run_is_correct(tmp_path):
    result, compared = _run(tiny.train_cell("sage", tmp_path))
    assert result["correct"], compared
