"""Plain reference of the benchmark's flows, written from the HINT paper's
description (arXiv:1905.10687, section 3) and its configs, in plain PyTorch.

It imports nothing of the measured program. It reads the weights in the
program's parameter layout, which the benchmark makes and hands to both
sides: per HAC block and tree depth ``L{level}``, the s-subnets then the
t-subnets of the level's nodes stacked along the first axis, ``w0`` padded
to the level's widest upper half with the condition's rows after it, ``w2``
and ``b2`` padded to the widest lower half. Fixed Householder
permutations are the matrix ``q_fixed``.

The HAC block is computed node by node, as the paper describes it: a node
of width ``dim`` splits at ``dim // 2``; in the forward direction both
halves are first transformed by the node's children, then the lower half
is coupled, ``x_l * exp(c * 0.636 * atan(s)) + t``, with ``(s, t)`` from
two 3-layer ReLU MLPs of the upper half (and the condition); the inverse
couples first, then inverts the children. The log-det sums the clamped
log-scales of every node.

Precision (``mode``): ``"float32"`` runs every product in full f32 (TF32
off); ``"float64"`` runs in double; ``"tf32"`` rounds both operands of
every product (forward and backward) to TF32's 10-bit mantissa, the
precision below the configs' f32: the benchmark's control.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

ATAN_SCALE = 0.636  # the reference implementation's truncated 2/pi


def full_f32() -> None:
    """Products in full f32 on the card: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """f32 rounded to nearest even at TF32's 10 mantissa bits."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32_round(a) @ tf32_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        return g @ tf32_round(b).transpose(-1, -2), tf32_round(a).transpose(-1, -2) @ g


def matmul(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "tf32":
        return _TF32MatMul.apply(a, b)
    return a @ b


def log_scale(s: torch.Tensor, clamp: float) -> torch.Tensor:
    return clamp * ATAN_SCALE * torch.atan(s)


@dataclasses.dataclass
class Node:
    dim: int
    split: int
    hidden: int
    leaf: bool
    level: int
    offset: int
    upper: Optional["Node"] = None
    lower: Optional["Node"] = None
    index: int = -1


def _tree(dim: int, widths: Tuple[int, ...], max_splits: int, min_split: int, level: int, offset: int) -> Node:
    if len(widths) == 0:
        widths = (dim,)
    if len(widths) == 1:
        widths = widths + widths
    split = dim // 2
    leaf = not (dim >= 2 * min_split and max_splits != 0)
    node = Node(dim, split, widths[0], leaf, level, offset)
    if not leaf:
        node.upper = _tree(split, widths[1:], max_splits - 1, min_split, level + 1, offset)
        node.lower = _tree(dim - split, widths[1:], max_splits - 1, min_split, level + 1, offset + split)
    return node


class HAC:
    """One hierarchical affine coupling block over a parameter dict."""

    def __init__(self, dim: int, widths: Sequence[int], cond_dim: int = 0, clamp: float = 4.0,
                 max_splits: int = -1, min_split: int = 2):
        self.dim, self.cond_dim, self.clamp = dim, cond_dim, clamp
        self.root = _tree(dim, tuple(widths), max_splits, min_split, 0, 0)
        self.levels: List[List[Node]] = []
        stack = [self.root]
        while stack:
            nd = stack.pop()
            while len(self.levels) <= nd.level:
                self.levels.append([])
            self.levels[nd.level].append(nd)
            if not nd.leaf:
                stack += [nd.upper, nd.lower]
        for lvl in self.levels:
            lvl.sort(key=lambda n: n.offset)
            for i, nd in enumerate(lvl):
                nd.index = i

    def shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Leaf name (``L{level}.w0`` ...) -> shape, in the program's order."""
        out = {}
        for li, lvl in enumerate(self.levels):
            u, h = 2 * len(lvl), lvl[0].hidden
            i_max = max(n.split for n in lvl) + self.cond_dim
            o_max = max(n.dim - n.split for n in lvl)
            out.update({f"L{li}.w0": (u, i_max, h), f"L{li}.b0": (u, h), f"L{li}.w1": (u, h, h),
                        f"L{li}.b1": (u, h), f"L{li}.w2": (u, h, o_max), f"L{li}.b2": (u, o_max)})
        return out

    def nodes(self):
        return [nd for lvl in self.levels for nd in lvl]

    def _subnet(self, p, pre, nd: Node, which: int, h: torch.Tensor, mode: str) -> torch.Tensor:
        lvl = self.levels[nd.level]
        i = which * len(lvl) + nd.index
        i_max = max(n.split for n in lvl)
        w0 = p[f"{pre}L{nd.level}.w0"][i]
        w0 = torch.cat([w0[: nd.split], w0[i_max: i_max + self.cond_dim]])
        out = nd.dim - nd.split
        h = torch.relu(matmul(h, w0, mode) + p[f"{pre}L{nd.level}.b0"][i])
        h = torch.relu(matmul(h, p[f"{pre}L{nd.level}.w1"][i], mode) + p[f"{pre}L{nd.level}.b1"][i])
        return matmul(h, p[f"{pre}L{nd.level}.w2"][i][:, :out], mode) + p[f"{pre}L{nd.level}.b2"][i][:out]

    def _node(self, p, pre, nd: Node, x, cond, rev: bool, mode: str):
        xu, xl = x[:, : nd.split], x[:, nd.split:]
        ju = jl = 0.0
        if not nd.leaf and not rev:
            xu, ju = self._node(p, pre, nd.upper, xu, cond, rev, mode)
            xl, jl = self._node(p, pre, nd.lower, xl, cond, rev, mode)
        h = xu if cond is None else torch.cat([xu, cond], dim=1)
        s = self._subnet(p, pre, nd, 0, h, mode)
        t = self._subnet(p, pre, nd, 1, h, mode)
        ls = log_scale(s, self.clamp)
        if not rev:
            xl = torch.exp(ls) * xl + t
            j = ls.sum(dim=1)
        else:
            xl = (xl - t) / torch.exp(ls)
            j = -ls.sum(dim=1)
        if not nd.leaf and rev:
            xu, ju = self._node(p, pre, nd.upper, xu, cond, rev, mode)
            xl, jl = self._node(p, pre, nd.lower, xl, cond, rev, mode)
        return torch.cat([xu, xl], dim=1), j + ju + jl

    def __call__(self, p, pre: str, x, cond, rev: bool, mode: str):
        return self._node(p, pre, self.root, x, cond, rev, mode)


class Flow:
    """A chain of ops, each ``("hac", HAC)`` or ``("perm", dim)``, whose
    parameters are ``b{i}.`` + the op's leaf names."""

    def __init__(self, ops: Sequence[Tuple[str, object]], dim: int, cond_dim: int):
        self.ops, self.dim, self.cond_dim = list(ops), dim, cond_dim

    def shapes(self) -> Dict[str, Tuple[int, ...]]:
        out = {}
        for i, (kind, op) in enumerate(self.ops):
            if kind == "hac":
                out.update({f"b{i}.{k}": s for k, s in op.shapes().items()})
            else:
                out[f"b{i}.q_fixed"] = (op, op)
        return out

    def trainable(self) -> List[str]:
        return [k for k in self.shapes() if not k.endswith("q_fixed")]

    def forward(self, p, x, cond=None, mode: str = "float32"):
        full_f32()
        ld = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for i, (kind, op) in enumerate(self.ops):
            if kind == "hac":
                x, j = op(p, f"b{i}.", x, cond, False, mode)
                ld = ld + j
            else:
                x = matmul(x, p[f"b{i}.q_fixed"], mode)
        return x, ld

    def inverse(self, p, z, cond=None, mode: str = "float32"):
        full_f32()
        ld = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
        for i, (kind, op) in reversed(list(enumerate(self.ops))):
            if kind == "hac":
                z, j = op(p, f"b{i}.", z, cond, True, mode)
                ld = ld + j
            else:
                z = matmul(z, p[f"b{i}.q_fixed"].transpose(0, 1), mode)
        return z, ld


def householder(vs: torch.Tensor) -> torch.Tensor:
    """Q = H_1 ... H_n of the reflection vectors ``vs`` (n, d), applied
    one after another to the identity."""
    q = torch.eye(vs.shape[1], dtype=vs.dtype, device=vs.device)
    for v in vs / torch.linalg.norm(vs, dim=1, keepdim=True):
        q = q - 2.0 * torch.outer(q @ v, v)
    return q
