"""Plain reference of the training step the configs state (HINT's
``train_unconditional.py``): the maximum-likelihood loss, the clamped
coupled-L2 Adam, the learning-rate schedule, and the batch order and input
noise that a training epoch draws from its generator. Imports nothing of
the measured program.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

GRAD_CLAMP = 5.0  # per element, before the optimizer
ADAM_EPS = 1e-4  # added after the square root
WARMUP_FACTOR = 3e-2  # the learning rate's factor in the first pre_low_lr epochs
NOISE_STD = 0.01  # Gaussian input noise on x


def lr_at(epoch: int, cfg: dict) -> float:
    """The learning rate of one epoch (torch 1.x ``StepLR`` closed form
    after the warm-up)."""
    if epoch < cfg["pre_low_lr"]:
        return cfg["lr_init"] * WARMUP_FACTOR
    return cfg["lr_init"] * cfg["final_decay"] ** (epoch / cfg["n_epochs"])


def nll_terms(z: torch.Tensor, logdet: torch.Tensor) -> tuple:
    """The loss's two terms: mean 1/2 |z|^2 and -mean log|det J|."""
    return 0.5 * (z * z).sum(dim=1).mean(), -logdet.mean()


def nll(z: torch.Tensor, logdet: torch.Tensor) -> torch.Tensor:
    t1, t2 = nll_terms(z, logdet)
    return t1 + t2


def epoch_batches(generator: torch.Generator, x: torch.Tensor, y: Optional[torch.Tensor], batch: int,
                  n_batches: int, steps: int) -> List[Tuple[torch.Tensor, Optional[torch.Tensor]]]:
    """The first ``steps`` noisy batches of an epoch: one permutation of the
    rows from the epoch's generator, drop-last slices of it, then per step
    the noise of the whole batch from the same generator."""
    perm = torch.randperm(x.shape[0], generator=generator, device=x.device)
    rows = perm[: n_batches * batch]
    out = []
    for b in range(steps):
        r = rows[b * batch: (b + 1) * batch]
        xb = x[r]
        noise = torch.randn(xb.shape, generator=generator, device=x.device, dtype=xb.dtype)
        out.append((xb + NOISE_STD * noise, None if y is None else y[r]))
    return out


class Adam:
    """The update rule: clamp each gradient element to +-5, add
    ``wd * theta``, then Adam with bias correction and eps after the root."""

    def __init__(self, params: Dict[str, torch.Tensor], betas: Tuple[float, float], wd: float):
        self.betas, self.wd, self.step = betas, wd, 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], lr: float) -> None:
        b1, b2 = self.betas
        self.step += 1
        bc1, bc2 = 1 - b1 ** self.step, 1 - b2 ** self.step
        for k, p in params.items():
            g = grads[k].clamp(-GRAD_CLAMP, GRAD_CLAMP)
            if self.wd:
                g = g + self.wd * p
            self.mu[k] = b1 * self.mu[k] + (1 - b1) * g
            self.nu[k] = b2 * self.nu[k] + (1 - b2) * g * g
            p -= (lr / bc1) * self.mu[k] / ((self.nu[k] / bc2).sqrt() + ADAM_EPS)
