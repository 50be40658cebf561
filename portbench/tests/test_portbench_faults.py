"""A whole run on the CPU, the look for a card skipped, with the timed
path broken underneath: ``correct`` comes out false for each fault the
cells can have.  (One card: no exchange between chips to leave out.)"""

import pytest
import torch

from portbench import calibrate
from portbench.tests import tiny


@pytest.mark.parametrize("name", ["mvcnn.train.guided_b128", "r3d.train.guided_b8"])
def test_train_step_that_leaves_the_state_unchanged(monkeypatch, name):
    monkeypatch.setattr(torch.optim.SGD, "step", lambda self, closure=None: None)
    result = tiny.run(name)
    assert not result["correct"]
    assert result["checks"]["change_gap"]["value"] > 0.9


def _faulted_run(fault, name):
    """A tiny run with one of ``calibrate.py``'s planted faults."""
    undo = calibrate.FAULTS[fault]()
    try:
        return tiny.run(name)
    finally:
        undo()


@pytest.mark.parametrize("name", ["mvcnn.train.guided_b128", "r3d.train.guided_b8"])
def test_train_step_on_half_the_batch(name):
    result = _faulted_run("half", name)
    assert not result["correct"]
    assert result["checks"]["loss_gap"]["value"] > tiny.LIMITS["loss_gap"]


def test_train_step_that_ignores_the_mask():
    """The window's checked step pads its batch (the tiny 2-D split does not
    divide by the batch); counting its padding, in the loss or in the
    batch statistics, is a fault only that step shows."""
    result = _faulted_run("mask", "mvcnn.train.guided_b128")
    assert not result["correct"]
    assert result["checks"]["window_loss_gap"]["value"] > tiny.LIMITS["window_loss_gap"]


@pytest.mark.parametrize("name", ["mvcnn.train.guided_b128", "r3d.train.guided_b8"])
def test_train_decision_inverted_where_it_is_made(name):
    result = _faulted_run("decision", name)
    assert not result["correct"]
    assert result["checks"]["decisions_differ"]["value"] > 0


def _predict_patch(monkeypatch, change):
    from greedy_multimodal_learning_tpu_torch.engine.framework import Trainer

    plain = Trainer.predict

    def broken(self, generator, steps=None):
        return change(plain(self, generator, steps))

    monkeypatch.setattr(Trainer, "predict", broken)


@pytest.mark.parametrize("name", ["mvcnn.serve.b128", "r3d.serve.b8"])
def test_serve_answers_half_the_rows(monkeypatch, name):
    def half(out):
        n = len(out["indices"]) // 2
        return {"indices": out["indices"][:n], "predictions": out["predictions"][:n],
                "probabilities": out["probabilities"][:n], "logits": [l[:n] for l in out["logits"]]}

    _predict_patch(monkeypatch, half)
    result = tiny.run(name)
    assert not result["correct"] and result["checks"]["rows_missing"]["value"] > 0


@pytest.mark.parametrize("name", ["mvcnn.serve.b128", "r3d.serve.b8"])
def test_serve_alters_an_answer(monkeypatch, name):
    def alter(out):
        out["logits"][0] = out["logits"][0].copy()
        out["logits"][0][0, 0] += 0.5
        return out

    _predict_patch(monkeypatch, alter)
    result = tiny.run(name)
    assert not result["correct"] and result["checks"]["logit_gap"]["value"] > tiny.LIMITS["logit_gap"]
