"""Experiment sweep drivers and the reference-scale campaign (port of
``hint_tpu/experiments``); the campaign's stages are in
``hint_tpu_torch.experiments.campaign``, run as ``python -m
hint_tpu_torch.experiments.campaign <stage>``."""

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
