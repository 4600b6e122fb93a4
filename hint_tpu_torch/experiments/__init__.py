"""Experiment sweep drivers (port of ``hint_tpu/experiments``); the
campaign (``hint_tpu/experiments/campaign.py``) waits for ROADMAP M12."""

from hint_tpu_torch.experiments.drivers import (
    UCI_CONFIGS,
    collect_shape_results,
    eval_shapes,
    test_likelihood,
    train_and_evaluate,
    uci_collect_results,
    uci_train_and_eval,
)

__all__ = [
    "UCI_CONFIGS",
    "train_and_evaluate",
    "collect_shape_results",
    "test_likelihood",
    "uci_train_and_eval",
    "uci_collect_results",
    "eval_shapes",
]
