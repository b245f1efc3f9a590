"""A run with the timed path broken underneath comes out not correct: the
Krylov kernel returning its state unchanged, and the answer altered where
the entry produces it.  The same run unbroken comes out correct.  (No cell
batches requests or spans chips, so those faults cannot occur.)"""
import dataclasses

import pytest
import torch

import cpkrylov_tpu_torch as cpt
from cpkrylov_tpu_torch import solvers

from ._tiny import cells, run_tiny


def _unchanged_state(kernel):
    def broken(b, A, C, M, opts, mstate, B=None):
        res = kernel(b, A, C, M, opts, mstate, B=B)
        return dataclasses.replace(res, x=torch.zeros_like(res.x),
                                   y=torch.zeros_like(res.y))
    return broken


def _altered_answer(entry):
    def broken(*args, **kwargs):
        out = entry(*args, **kwargs)
        x = out.x.clone()
        i = int(torch.argmax(torch.abs(x)))
        x[i] = x[i] * (1.0 + 1e-2)
        return dataclasses.replace(out, x=x, x1=x[:out.x1.numel()],
                                   x2=x[out.x1.numel():])
    return broken


@pytest.mark.parametrize("cell", cells())
def test_sound_run_is_correct(cell):
    res, _ = run_tiny(cell)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("cell", cells())
def test_unchanged_state_is_caught(cell, monkeypatch):
    monkeypatch.setitem(solvers.SOLVERS, "cpminres",
                        _unchanged_state(solvers.SOLVERS["cpminres"]))
    res, _ = run_tiny(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", cells())
def test_altered_answer_is_caught(cell, monkeypatch):
    monkeypatch.setattr(cpt, "solve", _altered_answer(cpt.solve))
    res, _ = run_tiny(cell)
    assert not res["correct"], res["checks"]
