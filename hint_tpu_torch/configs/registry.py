"""Declarative config registry (port of ``hint_tpu/configs/registry.py``).

A config is a frozen dataclass looked up by the reference module name, e.g.
``plus_shape.unconditional_hint_4_full``; nothing is built until
``build_model()``, ``make_trainer()`` or ``load_data()`` is called. All five
model families build; the toy and the UCI data load.
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

_SUFFIX_NAME = {  # reference `model.name` values used in suffix strings
    "plus-shape": "plus-shape",
    "lens-shape": "lens-shape1",  # data.py:83 quirk
    "fourier-curve": "fourier-curve",
    "power": "power",
    "gas": "gas",
    "miniboone": "miniboone",
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
    def ndim_z(self) -> int:
        if self.model_type == "conditional_hint":
            return self.ndim_x + self.ndim_y  # two-lane latent
        return self.ndim_x

    @property
    def is_conditional(self) -> bool:
        return self.model_type in ("cinn", "recursive_cinn", "conditional_hint")

    @property
    def is_uci(self) -> bool:
        return self.data in ("power", "gas", "miniboone")

    @property
    def kind(self) -> str:
        """Trainer kind (hint_tpu_torch.train.trainer)."""
        if self.model_type == "conditional_hint":
            return "hint"
        if self.is_conditional:
            return "cinn"
        return "unconditional"

    @property
    def suffix(self) -> str:
        """Run identifier, mirroring the reference suffix scheme
        (e.g. configs/plus_shape/unconditional_hint_4_full.py:18)."""
        base = _SUFFIX_NAME[self.data]
        tail = self.name.split(".", 1)[1]
        if self.is_uci and tail.startswith(self.data + "_"):
            # uci modules embed the dataset name (configs/uci_data/power_hint_8.py:17)
            tail = tail[len(self.data) + 1 :]
        return f"{base}_{tail.replace('_', '-')}"

    def build_model(self, compute_dtype: str = "float32", impl: str = "levelwise", device=None):
        """The config's model on ``device`` (CUDA unless named), with zeroed
        parameters: fill them with ``model.init(generator)`` or load a
        checkpoint."""
        d, dy = self.ndim_x, _DATA_DIMS[self.data][1]
        common = dict(compute_dtype=compute_dtype, device=resolve_device(device))
        if self.model_type == "inn":
            return builders.inn(d, self.n_blocks, self.hidden, self.perm_fixed, **common)
        if self.model_type == "hint":
            return builders.hint(
                d, self.n_blocks, self.c_internal, self.perm_fixed, self.max_splits,
                reshuffle=self.reshuffle, impl=impl, **common,
            )
        if self.model_type == "cinn":
            return builders.cinn(d, dy, self.n_blocks, self.hidden, self.perm_fixed, **common)
        if self.model_type == "recursive_cinn":
            return builders.recursive_cinn(
                d, dy, self.n_blocks, self.c_internal, self.perm_fixed, self.max_splits,
                impl=impl, **common,
            )
        if self.model_type == "conditional_hint":
            # the external coupling uses hidden; the y-lane coupling's width is
            # the per-config hidden_y (conditional_hint_*_full.py:78-89)
            return builders.conditional_hint(
                d, dy, self.n_blocks, self.c_internal, hidden_external=self.hidden,
                hidden_y=self.hidden_y if self.hidden_y is not None else self.hidden // 2,
                perm_fixed=self.perm_fixed, max_splits=self.max_splits, impl=impl, **common,
            )
        raise ValueError(f"unknown model_type {self.model_type!r}")

    def make_trainer(
        self,
        mesh=None,
        compute_dtype: str = "float32",
        impl: str = "levelwise",
        lr_semantics: str = "legacy",
        remat: bool = False,
        device=None,
    ):
        """The config's model under a ``Trainer`` on ``device`` (CUDA unless
        named), data-parallel over ``mesh`` (a ``parallel.Mesh``, whose
        device it then takes) where one is given."""
        from hint_tpu_torch.models.flow import with_remat
        from hint_tpu_torch.train.trainer import Trainer

        if mesh is not None and device is None:
            device = mesh.device
        model = self.build_model(compute_dtype=compute_dtype, impl=impl, device=device)
        if remat:
            model = with_remat(model)
        return Trainer(
            model=model,
            kind=self.kind,
            lr_init=self.lr_init,
            pre_low_lr=self.pre_low_lr,
            final_decay=self.final_decay,
            n_epochs=self.n_epochs,
            adam_betas=self.adam_betas,
            l2_weight_reg=self.l2_weight_reg,
            init_scale=self.init_scale,
            batch_size=self.batch_size,
            max_batches_per_epoch=self.max_batches_per_epoch,
            lr_semantics=lr_semantics,
            mesh=mesh,
            device=device,
        )

    def load_data(self, cache_dir: str = "data", uci_root: str = "."):
        """Returns ((x_train, y_train), (x_test, y_test)) numpy arrays. UCI
        sets are read from ``{uci_root}/uci_data/``; toy sets are cached
        in ``cache_dir``."""
        if self.vestigial:
            raise RuntimeError(
                f"{self.name} references the dropped 'fourier-curve' family and is "
                "not runnable in the reference either (abstract FourierCurveModel)."
            )
        if self.is_uci:
            from hint_tpu_torch.data.loaders import prepare_uci_data

            return prepare_uci_data(self.data, uci_root)
        from hint_tpu_torch.data.loaders import prepare_toy_data

        return prepare_toy_data(self.data_model(), self.n_train, self.n_test, cache_dir)

    def data_model(self):
        from hint_tpu_torch.data.fourier import LensShapeModel, PlusShapeModel

        if self.data == "plus-shape":
            return PlusShapeModel()
        if self.data == "lens-shape":
            return LensShapeModel()
        raise ValueError(f"no generative data model for {self.data!r}")


def get_config(name: str) -> Config:
    if name not in CONFIGS:
        raise KeyError(f"unknown config {name!r}; see hint_tpu_torch.configs.list_configs()")
    return Config(name=name, **CONFIGS[name])


def list_configs(prefix: str = "") -> Tuple[str, ...]:
    return tuple(sorted(k for k in CONFIGS if k.startswith(prefix)))
