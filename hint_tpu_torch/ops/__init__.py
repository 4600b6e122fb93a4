"""Invertible ops (bijectors) of the port; see ``ops/base.py`` for the protocol."""

from hint_tpu_torch.ops.base import Bijector
from hint_tpu_torch.ops.hac import HierarchicalAffineCoupling
from hint_tpu_torch.ops.householder import HouseholderPerm
from hint_tpu_torch.ops.subnets import MLPSpec

__all__ = ["Bijector", "MLPSpec", "HouseholderPerm", "HierarchicalAffineCoupling"]
