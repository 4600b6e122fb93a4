"""Evaluation (port of ``hint_tpu/evaluation``): model sampling so far."""

from hint_tpu_torch.evaluation.sampling import (
    sample_conditional,
    sample_conditional_hint,
    sample_joint_hint,
    sample_model,
)

__all__ = ["sample_conditional", "sample_conditional_hint", "sample_joint_hint", "sample_model"]
