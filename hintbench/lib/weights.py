"""Weights made on the device from the seed, in a few large calls, in the
parameter layout the reference's ``Flow.shapes()`` names (the program's).

``init``: every entry of every trainable leaf ``init_scale * N(0, 1)``,
padding included, as the configs' training starts. ``serve``: a model that
does work, as a trained one does: each weight N(0, 1) / sqrt(fan-in), the
last layer's weights and the biases times ``SERVE_LAST``, padding included.
A fixed permutation is the product of ``d`` Householder reflections of
N(0, 1) vectors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from hintbench.reference.flows import householder

SERVE_LAST = 0.05


def seeded(seed: int, purpose: int, device) -> torch.Generator:
    word = np.random.SeedSequence([int(seed), 0x6B1, int(purpose)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(word))


def _scale(key: str, shape, scheme: str, init_scale: float) -> float:
    if scheme == "init":
        return init_scale
    leaf = key.rsplit(".", 1)[1]
    if leaf[0] == "b":
        return SERVE_LAST
    fan_in = shape[-2]
    return (SERVE_LAST if leaf == "w2" else 1.0) / math.sqrt(fan_in)


@torch.no_grad()
def make(flow, seed: int, device, scheme: str, init_scale: float = 0.0) -> dict:
    shapes = flow.shapes()
    gen = seeded(seed, 1, device)
    train = [k for k in shapes if not k.endswith("q_fixed")]
    sizes = [math.prod(shapes[k]) for k in train]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for k, part in zip(train, flat.split(sizes)):
        out[k] = (part * _scale(k, shapes[k], scheme, init_scale)).view(shapes[k])
    for k in shapes:
        if k.endswith("q_fixed"):
            d = shapes[k][0]
            out[k] = householder(torch.randn(d, d, generator=gen, device=device))
    return {k: out[k] for k in shapes}
