"""Model sampling: the ``model_inverse`` semantics of each config family
(port of ``hint_tpu/evaluation/sampling.py``).

* unconditional: ``model.inverse(z)``;
* cINN / recursive cINN: ``model.inverse(z, y)``;
* two-lane conditional HINT: push (y, random x) forward for ``z_y``, then
  invert ``[z_y, z*]`` (conditional_hint_8_full.py:99-102 of the reference);
  plus ``sample_joint_hint`` and ``sample_conditional`` (...:104-113).

Latents come from an explicit ``torch.Generator`` on the model's device.
Nothing is compiled, so nothing is cached. Callers run these under
``torch.no_grad()`` or ``torch.inference_mode()`` when no gradient is wanted.

With a ``mesh`` (``hint_tpu_torch.parallel``) every rank draws all the
latents from the generator, as the unsharded call does, pads them to a
multiple of the ranks, inverts its block of rows and gathers the others';
every rank returns all n samples, those of the unsharded call.
"""

from __future__ import annotations

from typing import Optional

import torch

from hint_tpu_torch.models.flow import TwoLaneFlow
from hint_tpu_torch.parallel.mesh import map_rows


def _randn(generator: torch.Generator, n: int, dim: int) -> torch.Tensor:
    return torch.randn((n, dim), generator=generator, device=generator.device)


def _rows(y_target, n: int, device) -> torch.Tensor:
    y = torch.as_tensor(y_target, dtype=torch.float32, device=device).reshape(1, -1)
    return y.expand(n, -1).contiguous()


def sample_model(cfg, model, n: int, generator: torch.Generator, y_target=None, mesh=None) -> torch.Tensor:
    """Draw n samples of x from the model (x-space); ``y_target`` is the
    one condition of a conditional config."""
    if isinstance(model, TwoLaneFlow):
        return sample_conditional_hint(model, _rows(y_target, n, generator.device), generator, mesh=mesh)
    z = _randn(generator, n, model.dim)
    if cfg.is_conditional:
        return map_rows(lambda z, y: model.inverse(z, y)[0], mesh, z, _rows(y_target, n, generator.device))
    return map_rows(lambda z: model.inverse(z)[0], mesh, z)


def sample_conditional_hint(
    model: TwoLaneFlow, y: torch.Tensor, generator: torch.Generator, mesh=None
) -> torch.Tensor:
    """model_inverse (conditional_hint_8_full.py:99-102)."""
    test_z = _randn(generator, y.shape[0], model.dim_x)
    x_rand = _randn(generator, y.shape[0], model.dim_x)

    def invert(y, x_rand, test_z):
        z_y, _, _, _ = model.forward(y, x_rand)
        return model.inverse(z_y, test_z)[1]

    return map_rows(invert, mesh, y, x_rand, test_z)


def sample_joint_hint(model: TwoLaneFlow, n: int, generator: torch.Generator):
    """sample_joint (conditional_hint_8_full.py:104-106)."""
    z_y = _randn(generator, n, model.dim_y)
    z_x = _randn(generator, n, model.dim_x)
    y, x, _, _ = model.inverse(z_y, z_x)
    return y, x


def sample_conditional(
    model: TwoLaneFlow, y: torch.Tensor, generator: torch.Generator, z_x: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """sample_conditional (conditional_hint_8_full.py:108-113)."""
    if z_x is None:
        z_x = _randn(generator, y.shape[0], model.dim_x)
    z_y, _, _, _ = model.forward(y, z_x)
    _, x, _, _ = model.inverse(z_y, z_x)
    return x
