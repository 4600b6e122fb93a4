"""The check separates: a run whose timed path is broken underneath comes
out not correct, and so does the control, the plain reference in TF32 put
in the program's place. The CPU tests drive the whole of a run at a tiny
width (the harness's look for a card skipped); the card tests read the
control at each cell's own size, on three seeds."""

import math

import numpy as np
import pytest
import torch

import hintbench.run as RUN
from hintbench.lib import check
from hintbench.lib.serve_cell import ServeCell
from hintbench.lib.train_cell import TrainCell
from hintbench.tests.conftest import cell as find_cell
from hintbench.tests.conftest import tiny_cell

CPU = torch.device("cpu")
TRAIN = ("hint4-train", "rcinn4-train")
SERVE = ("hint4-serve", "rcinn4-posterior")


def _run(workload, seed=5):
    """A whole run at a tiny size; a serving window long enough for each
    client's first pass through its list, which holds the checked requests."""
    cell = tiny_cell(workload)
    return RUN.run_cell(cell, seed, 3.0 if cell.traffic["kind"] == "serve" else 0.5, False, CPU, strict=False)


@pytest.mark.parametrize("workload", TRAIN + SERVE)
def test_a_sound_run_is_correct(workload):
    out = _run(workload)
    assert out["correct"], out["check"]
    assert list(out)[-1] == "check" and out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("workload", TRAIN)
def test_a_step_that_leaves_the_state_unchanged_is_caught(workload, monkeypatch):
    from hint_tpu_torch.train.optim import ClampedAdam

    def unchanged(self, lr):
        for p in self.params.values():
            p.grad = None

    monkeypatch.setattr(ClampedAdam, "update", unchanged)
    out = _run(workload)
    assert not out["correct"] and out["check"]["change_gap"]["value"] == 1.0


@pytest.mark.parametrize("workload", TRAIN)
def test_half_of_the_batch_left_out_is_caught(workload, monkeypatch):
    from hint_tpu_torch.train.trainer import Trainer

    def half(self, x, y, generator):
        x = self._noisy(x, generator)
        n = x.shape[0] // 2
        return x[:n], (None if y is None else y[:n])

    monkeypatch.setattr(Trainer, "_rows", half)
    assert not _run(workload)["correct"]


@pytest.mark.parametrize("workload", SERVE)
def test_an_answer_altered_where_it_is_produced_is_caught(workload, monkeypatch):
    from hint_tpu_torch.serve import InferenceService

    sample, log_prob = InferenceService._sample_fn, InferenceService._log_prob_fn

    def altered_sample(self, generator, y):
        x = sample(self, generator, y)
        x[0, 0] += 0.05
        return x

    def altered_log_prob(self, x, y):
        lp = log_prob(self, x, y)
        lp[0] += 0.5
        return lp

    monkeypatch.setattr(InferenceService, "_sample_fn", altered_sample)
    monkeypatch.setattr(InferenceService, "_log_prob_fn", altered_log_prob)
    assert not _run(workload)["correct"]


@pytest.mark.parametrize("workload", TRAIN)
def test_the_control_in_the_programs_place_is_caught_in_training(workload, monkeypatch):
    monkeypatch.setattr(TrainCell, "_first_steps", lambda self: self.reference("tf32"))
    assert not _run(workload)["correct"]


@pytest.mark.parametrize("workload", SERVE)
def test_the_control_in_the_programs_place_is_caught_in_serving(workload, monkeypatch):
    monkeypatch.setattr(ServeCell, "_call",
                        lambda self, r: self.expected([r], "tf32")[0].numpy().astype(np.float32))
    assert not _run(workload)["correct"]


@pytest.mark.card
@pytest.mark.parametrize("workload", TRAIN + SERVE)
def test_the_control_fails_and_the_program_passes_at_the_cells_size_on_card(cuda, workload):
    """Three seeds at the cell's own size: the program's numbers within
    their limits, the control's over at least one."""
    import hintbench.sweep as SW

    cell = find_cell(workload)
    for seed in (101, 202, 303):
        if cell.traffic["kind"] == "train":
            r = SW.train_readings(cell, seed, cuda)
        else:
            r = SW.serve_readings(cell, seed, cuda, 2.0)
        assert check.verdict(r["port"], cell.limits)[0], r["port"]
        assert not check.verdict(r["control"], cell.limits)[0], r["control"]
        assert all(math.isfinite(v) for v in r["port"].values())
