"""Batch ensemble scoring on binned data, on a CompiledEnsemble's arrays.

Port of ddt_tpu/ops/predict.py's binned path. `predict_raw_effective`
takes the pushed-down, tree-padded arrays that models/tree.CompiledEnsemble
builds once per model (every node below a leaf inherits the leaf's value;
leaves and the nodes below them carry feature -1 and threshold +BIG, so a
row walks to the bottom level) and returns raw margins [R] (one class) or
[R, C].

`prepare` turns those arrays into what the implementation for their
device consumes, once per model (backends cache it); `predict_prepared`
scores rows with it. Two implementations of the one function:

- the kernel, ops/predict_cuda.traverse_cuda (csrc/traverse.cu), taken
  for CUDA tensors;
- the plain version, `predict_effective_plain`, taken for CPU tensors. It
  mirrors the reference's `_descend_comp` (every internal node's
  comparison bit, then a D-step descent selecting the path node's bit) and
  `_predict_effective`'s per-chunk class accumulation: rows in chunks of
  ROW_CHUNK, trees in chunks of `tree_chunk`, acc += the chunk's class
  sums, then base + lr * acc. Where the reference used one-hot
  compare+reduce to avoid TPU gathers, this uses gathers: the selected
  integers are the same. The chunk's class sums are taken tree by tree in
  tree order, the order of the CUDA kernels, so the plain version equals
  them bitwise and a row's score does not depend on its batch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ddt_tpu_torch.ops import predict_cuda

#: Rows per plain-version step: the comparison bits of one step are
#: [rows, tree_chunk, 2^D - 1], ~32M entries at 8192 x 64 x 63.
ROW_CHUNK = 8_192


def descend_plain(feat, thr, X, max_depth: int, dl=None,
                  missing_bin_value: int = -1, cat=None) -> torch.Tensor:
    """Relative bottom-level node per (row, tree): int64 [Rc, Tc].

    feat/thr [Tc, N] pushed-down; X integer bins [Rc, F]. A pushed-down
    leaf (feature -1) reads 0 and, against thr = +BIG, always goes left;
    categorical nodes send the matched bin left (gated on feature >= 0);
    a row in the reserved missing bin follows the node's default
    direction."""
    n_int = (1 << max_depth) - 1
    f = feat[:, :n_int].to(torch.int64)
    t = thr[:, :n_int].to(torch.int32)
    colval = X.to(torch.int32)[:, f.clamp(min=0)]            # [Rc, Tc, Nint]
    colval = torch.where(f >= 0, colval, 0)
    comp = colval > t
    if cat is not None:
        cat_eff = cat[:, :n_int].bool() & (f >= 0)
        comp = torch.where(cat_eff, colval != t, comp)
    if dl is not None:
        miss = colval == missing_bin_value
        comp = torch.where(miss, ~dl[:, :n_int].bool(), comp)
    k = torch.zeros(comp.shape[:2], dtype=torch.int64, device=X.device)
    for d in range(max_depth):
        node = k + ((1 << d) - 1)
        go = comp.gather(2, node[:, :, None])[:, :, 0]
        k = 2 * k + go.to(torch.int64)
    return k


def predict_effective_plain(eff_feat, eff_thr, bot_val, cls_oh, X, *,
                            max_depth: int, learning_rate: float,
                            base: float, tree_chunk: int = 64, eff_dl=None,
                            missing_bin_value: int = -1,
                            eff_cat=None) -> torch.Tensor:
    """Plain version: f32 [R, C] margins."""
    R = X.shape[0]
    Tpad, C = cls_oh.shape
    if Tpad % tree_chunk:
        raise ValueError(f"padded tree count {Tpad} is not a multiple of "
                         f"tree_chunk={tree_chunk}")
    cls = cls_oh.argmax(dim=1).tolist()          # class of each tree
    bot_val = bot_val.to(torch.float32)
    outs = []
    for r0 in range(0, R, ROW_CHUNK):
        xr = X[r0:r0 + ROW_CHUNK]
        acc = torch.zeros((xr.shape[0], C), dtype=torch.float32,
                          device=X.device)
        for t0 in range(0, Tpad, tree_chunk):
            ts = slice(t0, t0 + tree_chunk)
            k = descend_plain(
                eff_feat[ts], eff_thr[ts], xr, max_depth,
                dl=None if eff_dl is None else eff_dl[ts],
                missing_bin_value=missing_bin_value,
                cat=None if eff_cat is None else eff_cat[ts])
            tidx = torch.arange(k.shape[1], device=X.device)[None, :]
            vals = bot_val[ts][tidx, k]                          # [Rc, Tc]
            # Class sums tree by tree, the kernels' order: a row's score
            # then depends on nothing but the row (a matmul's order
            # changes with the batch's row count).
            cs = torch.zeros_like(acc)
            for j in range(vals.shape[1]):
                c = cls[t0 + j]
                cs[:, c] += vals[:, j]
            acc = acc + cs
        outs.append(acc)
    acc = torch.cat(outs) if outs else torch.zeros(
        (0, C), dtype=torch.float32, device=X.device)
    return base + learning_rate * acc


class PlainOperands(NamedTuple):
    """The plain version's operands: a CompiledEnsemble's arrays on the
    CPU."""

    eff_feat: torch.Tensor
    eff_thr: torch.Tensor
    bot_val: torch.Tensor
    cls_oh: torch.Tensor
    max_depth: int
    eff_dl: torch.Tensor | None
    eff_cat: torch.Tensor | None


def prepare(eff_feat, eff_thr, bot_val, cls_oh, *, max_depth: int,
            eff_dl=None, eff_cat=None):
    """What `predict_prepared` consumes, built once per model: the kernel's
    packed Tables for arrays on a card, PlainOperands on the CPU."""
    if eff_feat.device.type == "cuda":
        return predict_cuda.pack_tables(eff_feat, eff_thr, bot_val, cls_oh,
                                        max_depth, eff_dl=eff_dl,
                                        eff_cat=eff_cat)
    if eff_feat.device.type == "cpu":
        return PlainOperands(eff_feat, eff_thr, bot_val, cls_oh, max_depth,
                             eff_dl, eff_cat)
    raise TypeError(f"no traversal implementation for {eff_feat.device}")


def predict_prepared(ops, X, *, learning_rate: float, base: float,
                     tree_chunk: int = 64,
                     missing_bin_value: int = -1) -> torch.Tensor:
    """Raw margins [R] (one class) or [R, C] from `prepare`'s operands: the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if X.device.type == "cuda":
        out = predict_cuda.traverse_cuda(
            ops, X, learning_rate=learning_rate, base=base,
            tree_chunk=tree_chunk, missing_bin_value=missing_bin_value)
    elif X.device.type == "cpu":
        if not isinstance(ops, PlainOperands):
            raise TypeError("CPU rows need operands prepared on the CPU")
        out = predict_effective_plain(
            ops.eff_feat, ops.eff_thr, ops.bot_val, ops.cls_oh, X,
            max_depth=ops.max_depth, learning_rate=learning_rate, base=base,
            tree_chunk=tree_chunk, eff_dl=ops.eff_dl,
            missing_bin_value=missing_bin_value, eff_cat=ops.eff_cat)
    else:
        raise TypeError(f"no traversal implementation for {X.device}")
    return out[:, 0] if out.shape[1] == 1 else out


def predict_raw_effective(eff_feat, eff_thr, bot_val, cls_oh, X, *,
                          max_depth: int, learning_rate: float, base: float,
                          tree_chunk: int = 64, eff_dl=None,
                          missing_bin_value: int = -1,
                          eff_cat=None) -> torch.Tensor:
    """Raw margins [R] (one class) or [R, C] straight from a
    CompiledEnsemble's arrays: `prepare` then `predict_prepared`."""
    ops = prepare(eff_feat, eff_thr, bot_val, cls_oh, max_depth=max_depth,
                  eff_dl=eff_dl, eff_cat=eff_cat)
    return predict_prepared(ops, X, learning_rate=learning_rate, base=base,
                            tree_chunk=tree_chunk,
                            missing_bin_value=missing_bin_value)
