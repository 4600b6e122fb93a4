"""Hierarchical affine coupling (HAC), the HINT core op
(port of ``hint_tpu/ops/hac.py``).

Semantics follow the reference tree (hint.py:21-133): recursive binary
split at ``dim // 2``; per-node ``s``/``t`` 3-layer ReLU subnets on
``x_upper (+ cond)``; soft-clamped affine coupling of the lower half;
forward recurses into children before coupling, inverse couples before
recursing; the log-det sums over all tree nodes; optional per-node fixed
Householder reshuffle.

Parameters are level-stacked exactly as in the JAX package: all sibling
subnets at one tree depth live in one ``(2n, in, h)`` stack, s-subnets
then t-subnets along the leading axis, padded to the level's widest node.
Each level is an ``nn.ParameterDict`` named ``L{level}`` holding
``w0 b0 w1 b1 w2 b2``; reshuffle maps are buffers ``Q{level}``.

Engines (``impl``):

* ``levelwise``: one batched einsum per layer per level; the plain PyTorch
  version of the CUDA kernel.
* ``reference``: direct transcription of the recursion (correctness oracle).
* ``fused``: the whole-block CUDA kernel (``hac_fused``) on the card; on a
  CPU tensor it runs the levelwise engine.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from hint_tpu_torch.ops.base import Bijector, matmul_f32acc
from hint_tpu_torch.ops.clamp import soft_clamp_exp, soft_clamp_log
from hint_tpu_torch.ops.hac_fused import fused_block
from hint_tpu_torch.ops.householder import householder_matrix_product
from hint_tpu_torch.ops.subnets import MLPSpec

_LEAVES = ("w0", "b0", "w1", "b1", "w2", "b2")


class _TreeNode:
    """Static structure of one HAC tree node."""

    __slots__ = ("dim", "split", "hidden", "leaf", "upper", "lower", "offset", "level", "index")

    def __init__(self, dim, split, hidden, leaf, upper, lower, offset, level):
        self.dim = dim
        self.split = split
        self.hidden = hidden
        self.leaf = leaf
        self.upper = upper
        self.lower = lower
        self.offset = offset  # position of this node's segment in the flat feature axis
        self.level = level
        self.index = -1  # position within its level (set after level sort)


class _Level:
    """Static metadata of one tree depth."""

    __slots__ = ("nodes", "in_max", "out_max", "dim_max", "hidden", "out_mask")

    def __init__(self, nodes: List[_TreeNode], cond_dim: int):
        self.nodes = nodes
        self.in_max = max(nd.split for nd in nodes)
        self.out_max = max(nd.dim - nd.split for nd in nodes)
        self.dim_max = max(nd.dim for nd in nodes)
        self.hidden = nodes[0].hidden
        mask = np.zeros((len(nodes), 1, self.out_max), np.float32)
        for i, nd in enumerate(nodes):
            mask[i, 0, : nd.dim - nd.split] = 1.0
        self.out_mask = mask


def _normalize_c_internal(c_internal: Tuple[int, ...], dim: int) -> Tuple[int, ...]:
    """Width-list defaulting, mirroring hint.py:31-34."""
    ci = tuple(c_internal)
    if len(ci) == 0:
        ci = (dim,)
    if len(ci) == 1:
        ci = ci + ci
    return ci


def _build_tree(dim, c_internal, max_splits, min_split_size, offset, level) -> _TreeNode:
    ci = _normalize_c_internal(c_internal, dim)
    split = dim // 2
    is_leaf = not (dim >= 2 * min_split_size and max_splits != 0)
    upper = lower = None
    if not is_leaf:
        upper = _build_tree(split, ci[1:], max_splits - 1, min_split_size, offset, level + 1)
        lower = _build_tree(
            dim - split, ci[1:], max_splits - 1, min_split_size, offset + split, level + 1
        )
    return _TreeNode(dim, split, ci[0], is_leaf, upper, lower, offset, level)


def _levels(tree: _TreeNode, cond_dim: int) -> List[_Level]:
    """Nodes grouped by depth, each depth sorted by feature offset."""
    by_depth: List[List[_TreeNode]] = []

    def visit(node):
        while len(by_depth) <= node.level:
            by_depth.append([])
        by_depth[node.level].append(node)
        if not node.leaf:
            visit(node.upper)
            visit(node.lower)

    visit(tree)
    levels = []
    for lvl in by_depth:
        lvl.sort(key=lambda n: n.offset)
        for i, nd in enumerate(lvl):
            nd.index = i
        levels.append(_Level(lvl, cond_dim))
    return levels


def _index(rows) -> torch.Tensor:
    return torch.as_tensor(np.asarray(rows, np.int64))


class HierarchicalAffineCoupling(Bijector):
    """HAC block (the FrEIA-adapter defaults live at hint.py:108)."""

    IMPLS = ("levelwise", "reference", "fused")

    def __init__(
        self,
        dim: int,
        c_internal: Tuple[int, ...] = (),
        clamp: float = 4.0,
        max_splits: int = -1,
        min_split_size: int = 2,
        reshuffle: bool = False,
        compute_dtype: str = "float32",
        impl: str = "levelwise",
        cond_dim: int = 0,
    ):
        super().__init__(dim, cond_dim)
        # a typo'd impl string must fail loudly, not silently run levelwise
        if impl not in self.IMPLS:
            raise ValueError(f"unknown HAC impl {impl!r}; expected one of {self.IMPLS}")
        self.c_internal = tuple(c_internal)
        self.clamp = clamp
        self.max_splits = max_splits
        self.min_split_size = min_split_size
        self.reshuffle = reshuffle
        self.compute_dtype = compute_dtype
        self.impl = impl
        self.tree = _build_tree(dim, self.c_internal, max_splits, min_split_size, 0, 0)
        self.levels = _levels(self.tree, cond_dim)

        for li, lv in enumerate(self.levels):
            u, h, o = 2 * len(lv.nodes), lv.hidden, lv.out_max
            shapes = {
                "w0": (u, lv.in_max + cond_dim, h), "b0": (u, h),
                "w1": (u, h, h), "b1": (u, h),
                "w2": (u, h, o), "b2": (u, o),
            }
            self.add_module(
                f"L{li}",
                nn.ParameterDict({k: nn.Parameter(torch.zeros(s)) for k, s in shapes.items()}),
            )
            if reshuffle:
                self.register_buffer(f"Q{li}", torch.zeros(len(lv.nodes), lv.dim_max, lv.dim_max))
            # gather/scatter tables of the levelwise engine; column `dim` of
            # the zero-extended input stands for padding
            in_idx = [
                [nd.offset + k if k < nd.split else dim for k in range(lv.in_max)]
                for nd in lv.nodes
            ]
            out_sel, out_dst, seg_idx, seg_sel, seg_dst = [], [], [], [], []
            for i, nd in enumerate(lv.nodes):
                for m in range(nd.dim - nd.split):
                    out_sel.append(i * o + m)
                    out_dst.append(nd.offset + nd.split + m)
                seg_idx.append(
                    [nd.offset + k if k < nd.dim else dim for k in range(lv.dim_max)]
                )
                for k in range(nd.dim):
                    seg_sel.append(i * lv.dim_max + k)
                    seg_dst.append(nd.offset + k)
            for name, rows in (
                ("in_idx", in_idx), ("out_sel", out_sel), ("out_dst", out_dst),
                ("seg_idx", seg_idx), ("seg_sel", seg_sel), ("seg_dst", seg_dst),
            ):
                self.register_buffer(f"_{name}{li}", _index(rows), persistent=False)
            self.register_buffer(
                f"_out_mask{li}", torch.as_tensor(lv.out_mask), persistent=False
            )

    def level_params(self, li: int) -> nn.ParameterDict:
        return getattr(self, f"L{li}")

    def _subnet_spec(self, node: _TreeNode) -> MLPSpec:
        return MLPSpec(
            node.split + self.cond_dim, node.hidden, node.dim - node.split, self.compute_dtype
        )

    @property
    def n_params(self) -> int:
        """Logical (unpadded) parameter count, matching the reference's
        per-node subnets."""
        return sum(2 * self._subnet_spec(nd).n_params for lv in self.levels for nd in lv.nodes)

    # -- params (level-stacked layout, hac.py:171-209) --------------------------

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        for li, lv in enumerate(self.levels):
            stacks = {k: [] for k in _LEAVES}
            for which in range(2):  # 0: s-subnets, 1: t-subnets
                for nd in lv.nodes:
                    p = self._subnet_spec(nd).init(generator)
                    out_i = nd.dim - nd.split
                    w0 = p["w0"].new_zeros((lv.in_max + self.cond_dim, nd.hidden))
                    w0[: nd.split] = p["w0"][: nd.split]
                    w0[lv.in_max :] = p["w0"][nd.split :]  # condition rows start at in_max
                    stacks["w0"].append(w0)
                    stacks["b0"].append(p["b0"])
                    stacks["w1"].append(p["w1"])
                    stacks["b1"].append(p["b1"])
                    stacks["w2"].append(nn.functional.pad(p["w2"], (0, lv.out_max - out_i)))
                    stacks["b2"].append(nn.functional.pad(p["b2"], (0, lv.out_max - out_i)))
            lp = self.level_params(li)
            for k, v in stacks.items():
                lp[k].copy_(torch.stack(v))
            if self.reshuffle:
                q = getattr(self, f"Q{li}")
                q.copy_(torch.eye(lv.dim_max).expand_as(q))
                for i, nd in enumerate(lv.nodes):
                    vs = torch.randn((nd.dim, nd.dim), generator=generator, device=generator.device)
                    q[i, : nd.dim, : nd.dim] = householder_matrix_product(vs)

    # -- public API ---------------------------------------------------------------

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor] = None):
        if self.impl == "reference":
            return self._forward_recursive(self.tree, x, cond, rev=False)
        if self.impl == "fused":
            return fused_block(self, x, cond, rev=False)
        return self._forward_levelwise(x, cond)

    def inverse(self, y: torch.Tensor, cond: Optional[torch.Tensor] = None):
        if self.impl == "reference":
            return self._forward_recursive(self.tree, y, cond, rev=True)
        if self.impl == "fused":
            return fused_block(self, y, cond, rev=True)
        return self._inverse_levelwise(y, cond)

    # -- levelwise engine (the kernel's plain version) ------------------------------

    def _level_st(self, li: int, x: torch.Tensor, cond: Optional[torch.Tensor]):
        """Batched s, t for all nodes of one level: each (n, B, out_max),
        with padded output columns exactly zero."""
        lv = self.levels[li]
        n = len(lv.nodes)
        p = self.level_params(li)
        xe = torch.cat([x, x.new_zeros(x.shape[0], 1)], dim=1)
        xs = xe[:, getattr(self, f"_in_idx{li}")].transpose(0, 1)  # (n, B, in_max)
        if self.cond_dim > 0:
            xs = torch.cat([xs, cond[None].expand(n, *cond.shape)], dim=-1)

        def two(w):
            return w.reshape((2, n) + w.shape[1:])

        cdt = self.compute_dtype
        h = torch.relu(matmul_f32acc(xs, two(p["w0"]), cdt, "nbi,snio->snbo") + two(p["b0"])[:, :, None])
        h = torch.relu(matmul_f32acc(h, two(p["w1"]), cdt, "snbi,snio->snbo") + two(p["b1"])[:, :, None])
        h = matmul_f32acc(h, two(p["w2"]), cdt, "snbi,snio->snbo") + two(p["b2"])[:, :, None]
        mask = getattr(self, f"_out_mask{li}")
        return h[0] * mask, h[1] * mask

    def _scatter_lower(self, li: int, v: torch.Tensor) -> torch.Tensor:
        """(n, B, out_max) per-node values -> (B, dim), each node's first
        out_i columns on its lower segment and exact zeros elsewhere."""
        B = v.shape[1]
        flat = v.transpose(0, 1).reshape(B, -1)[:, getattr(self, f"_out_sel{li}")]
        return v.new_zeros(B, self.dim).index_copy(1, getattr(self, f"_out_dst{li}"), flat)

    def _couple_level(self, li: int, x: torch.Tensor, cond, rev: bool):
        """Apply (or invert) all couplings of one level; returns (x', logdet).
        Outside the lower segments log_e = T = 0, so x passes unchanged."""
        s, t = self._level_st(li, x, cond)
        log_e = soft_clamp_log(s, self.clamp)  # padded cols are exactly 0
        logdet = torch.sum(log_e, dim=(0, 2))
        le, tt = self._scatter_lower(li, log_e), self._scatter_lower(li, t)
        y = torch.exp(le) * x + tt if not rev else (x - tt) / torch.exp(le)
        return y, (logdet if not rev else -logdet)

    def _perm_level(self, li: int, x: torch.Tensor, rev: bool) -> torch.Tensor:
        """All (identity-padded, block-diagonal) node perms of a level as one
        batched einsum."""
        q = getattr(self, f"Q{li}")
        if rev:
            q = q.transpose(1, 2)
        B = x.shape[0]
        xe = torch.cat([x, x.new_zeros(B, 1)], dim=1)
        segs = xe[:, getattr(self, f"_seg_idx{li}")]  # (B, n, dim_max)
        out = torch.einsum("bni,nij->bnj", segs, q).reshape(B, -1)
        return x.index_copy(1, getattr(self, f"_seg_dst{li}"), out[:, getattr(self, f"_seg_sel{li}")])

    def _forward_levelwise(self, x: torch.Tensor, cond=None):
        # perms top-down, then couplings bottom-up (order per hint.py:62-99)
        if self.reshuffle:
            for li in range(len(self.levels)):
                x = self._perm_level(li, x, rev=False)
        logdet = self._zeros_logdet(x)
        for li in reversed(range(len(self.levels))):
            x, j = self._couple_level(li, x, cond, rev=False)
            logdet = logdet + j
        return x, logdet

    def _inverse_levelwise(self, y: torch.Tensor, cond=None):
        # couplings top-down, then un-perms bottom-up (order flip, hint.py:85-94)
        logdet = self._zeros_logdet(y)
        for li in range(len(self.levels)):
            y, j = self._couple_level(li, y, cond, rev=True)
            logdet = logdet + j
        if self.reshuffle:
            for li in reversed(range(len(self.levels))):
                y = self._perm_level(li, y, rev=True)
        return y, logdet

    # -- reference-order engine (correctness oracle) --------------------------------

    def _node_subnet(self, node: _TreeNode, which: int):
        """One node's unpadded subnet weights out of the level stack
        (which: 0 = s-subnet, 1 = t-subnet)."""
        lv = self.levels[node.level]
        p = self.level_params(node.level)
        i = which * len(lv.nodes) + node.index
        out_i = node.dim - node.split
        w0 = torch.cat(
            [p["w0"][i][: node.split], p["w0"][i][lv.in_max : lv.in_max + self.cond_dim]]
        )
        return {
            "w0": w0,
            "b0": p["b0"][i],
            "w1": p["w1"][i],
            "b1": p["b1"][i],
            "w2": p["w2"][i][:, :out_i],
            "b2": p["b2"][i][:out_i],
        }

    def _st(self, node: _TreeNode, x_upper: torch.Tensor, cond: Optional[torch.Tensor]):
        spec = self._subnet_spec(node)
        h = x_upper if self.cond_dim == 0 else torch.cat([x_upper, cond], dim=-1)
        return spec.apply(self._node_subnet(node, 0), h), spec.apply(self._node_subnet(node, 1), h)

    def _node_q(self, node: _TreeNode) -> torch.Tensor:
        return getattr(self, f"Q{node.level}")[node.index][: node.dim, : node.dim]

    def _forward_recursive(self, node: _TreeNode, x: torch.Tensor, cond, rev: bool):
        if not rev and self.reshuffle:
            x = x @ self._node_q(node)

        x_upper, x_lower = x[:, : node.split], x[:, node.split :]

        j_upper = j_lower = 0.0
        if (not node.leaf) and (not rev):
            x_upper, j_upper = self._forward_recursive(node.upper, x_upper, cond, rev)
            x_lower, j_lower = self._forward_recursive(node.lower, x_lower, cond, rev)

        s, t = self._st(node, x_upper, cond)
        if not rev:
            x_lower = soft_clamp_exp(s, self.clamp) * x_lower + t
            j = torch.sum(soft_clamp_log(s, self.clamp), dim=-1)
        else:
            x_lower = (x_lower - t) / soft_clamp_exp(s, self.clamp)
            j = -torch.sum(soft_clamp_log(s, self.clamp), dim=-1)

        if (not node.leaf) and rev:
            x_upper, j_upper = self._forward_recursive(node.upper, x_upper, cond, rev)
            x_lower, j_lower = self._forward_recursive(node.lower, x_lower, cond, rev)

        x = torch.cat([x_upper, x_lower], dim=-1)
        if rev and self.reshuffle:
            x = x @ self._node_q(node).T
        return x, j + j_upper + j_lower
