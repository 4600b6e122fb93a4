"""Declarative config registry (port of ``hint_tpu/configs/registry.py``).

A config is a frozen dataclass looked up by the reference module name, e.g.
``plus_shape.unconditional_hint_4_full``; nothing is built until
``build_model()`` is called. Only ``model_type == "hint"`` builds so far.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from hint_tpu_torch.configs.registry_data import CONFIGS
from hint_tpu_torch.models import builders
from hint_tpu_torch.ops.base import resolve_device

# dataset dimensionalities (x, y)
_DATA_DIMS = {
    "plus-shape": (100, 4),
    "lens-shape": (20, 2),
    "fourier-curve": (4, 1),
    "power": (6, 0),
    "gas": (8, 0),
    "miniboone": (42, 0),
}

# ROADMAP item that ports each model family not built yet
_NOT_PORTED = {
    "inn": "M3 (AffineCoupling)",
    "cinn": "M7 (conditional families)",
    "recursive_cinn": "M7 (conditional families)",
    "conditional_hint": "M7 (conditional families)",
}


@dataclasses.dataclass(frozen=True)
class Config:
    name: str
    data: str
    model_type: str  # inn | hint | cinn | recursive_cinn | conditional_hint
    n_blocks: int
    hidden: int
    c_internal: Optional[Tuple[int, ...]]
    max_splits: int
    perm_fixed: bool
    reshuffle: bool
    init_scale: float
    n_epochs: int
    max_batches_per_epoch: int
    batch_size: int
    n_train: Optional[int]
    n_test: Optional[int]
    lr_init: float
    pre_low_lr: int
    final_decay: float
    l2_weight_reg: float
    adam_betas: Tuple[float, float]
    vis_y_target: Optional[Tuple[float, ...]]
    vestigial: bool = False
    hidden_y: Optional[int] = None

    @property
    def ndim_x(self) -> int:
        return _DATA_DIMS[self.data][0]

    @property
    def ndim_y(self) -> int:
        return _DATA_DIMS[self.data][1] if self.is_conditional else 0

    @property
    def is_conditional(self) -> bool:
        return self.model_type in ("cinn", "recursive_cinn", "conditional_hint")

    def build_model(self, compute_dtype: str = "float32", impl: str = "levelwise", device=None):
        """The config's model on ``device`` (CUDA unless named), with zeroed
        parameters: fill them with ``model.init(generator)`` or load a
        checkpoint."""
        if self.model_type != "hint":
            raise NotImplementedError(
                f"model_type {self.model_type!r} is not ported yet (ROADMAP "
                f"{_NOT_PORTED.get(self.model_type, '?')})"
            )
        return builders.hint(
            self.ndim_x, self.n_blocks, self.c_internal, self.perm_fixed, self.max_splits,
            reshuffle=self.reshuffle, compute_dtype=compute_dtype, impl=impl,
            device=resolve_device(device),
        )


def get_config(name: str) -> Config:
    if name not in CONFIGS:
        raise KeyError(f"unknown config {name!r}; see hint_tpu_torch.configs.list_configs()")
    return Config(name=name, **CONFIGS[name])


def list_configs(prefix: str = "") -> Tuple[str, ...]:
    return tuple(sorted(k for k in CONFIGS if k.startswith(prefix)))
