"""Evaluation (port of ``hint_tpu/evaluation``): model sampling, the
multi-kernel MMD and the scalar metrics; the submodules ``abc`` (prior
sweep, quantile-ABC, model comparisons) and ``shape_fit`` are imported by
their callers."""

from hint_tpu_torch.evaluation.metrics import per_dim_likelihood, uci_log_likelihood
from hint_tpu_torch.evaluation.mmd import multi_mmd
from hint_tpu_torch.evaluation.sampling import (
    sample_conditional,
    sample_conditional_hint,
    sample_joint_hint,
    sample_model,
)

__all__ = [
    "multi_mmd",
    "sample_model",
    "uci_log_likelihood",
    "per_dim_likelihood",
    "sample_conditional",
    "sample_conditional_hint",
    "sample_joint_hint",
]
