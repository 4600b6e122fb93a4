"""The system under test: the configuration as the program builds it.

The program's registry entry is the template; the configuration file's
values replace its fields, so the file holds what runs. A full run
(``strict``) also requires the registry to agree with the file, so that a
drift between the two shows as an error and not as a different cell.
"""

from __future__ import annotations

import dataclasses

SHARED = ("model_type", "n_blocks", "hidden", "c_internal", "max_splits", "perm_fixed", "reshuffle",
          "init_scale", "n_epochs", "max_batches_per_epoch", "batch_size", "n_train", "lr_init", "pre_low_lr",
          "final_decay", "l2_weight_reg", "adam_betas", "vis_y_target")


def _value(v):
    return tuple(v) if isinstance(v, list) else v


def config(cfg: dict, strict: bool = True):
    from hint_tpu_torch.configs.registry import get_config

    base = get_config(cfg["registry"])
    fields = {k: _value(cfg[k]) for k in SHARED}
    if strict:
        differ = {k: (getattr(base, k), v) for k, v in fields.items() if getattr(base, k) != v}
        if differ or base.ndim_x != cfg["ndim_x"] or base.ndim_y != cfg["ndim_y"]:
            raise ValueError(f"the program's {cfg['registry']} differs from the configuration file: {differ}")
    return dataclasses.replace(base, **fields)
