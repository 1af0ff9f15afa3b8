"""CUDADevice: the port's DeviceBackend (port of ddt_tpu/backends/tpu.py's
single-device path).

Data, labels, gradients and boosting state live as torch tensors on
`cfg.device`. On "cuda" the histogram and traversal steps launch the
port's kernels (ops/hist_cuda, ops/predict_cuda); on "cpu" the same code
runs their plain versions, which is how the tests drive it. A "cuda"
config without a visible card raises: the backend never moves to the CPU
by itself.

Scoring keeps a small per-model cache of the scoring operands on the
device, keyed on the model's content token (the reference's
TPUDevice._predict_fn keeps the same cache), so repeated scoring of an
unchanged model uploads, pushes down and packs nothing: a cache hit
launches only the kernel. The entry holds the tier that serves the model:
with cfg.predict_impl="lut" / "lut4" the quantized tables of
ops/predict_lut (kernels K4 / K5), walked down int4 -> int8 -> f32 when a
fits guard refuses the shape; otherwise the traversal kernel's f32
tables. `resolved_predict_impl(token)` reports the tier. That cache
serves api.predict. A served model owns its operands instead
(`prepare_scoring`, which builds them outside the cache, and
`predict_raw(operands=)`), as the reference's RestoredModel does: N
resident models never rebuild each other's tables, and dropping the
model frees them.

Fused rounds (port of TPUDevice.grow_rounds / grow_rounds_masked /
grow_rounds_eval): one boosting round (gradients -> bagging mask -> one
tree per output column, each added to pred -> packed trees and loss, and
with an eval set each tree also routed through the validation rows and
the round's metric taken by its tensor twin) is one function, `_round`,
whose per-round inputs (the round index, the colsample masks) are
tensors. On "cuda" it is captured once as a CUDA graph (`_RoundGraph`)
and replayed once a round, so a round costs the host a replay and a few
stream-ordered copies where the granular loop issues every launch of the
level loop; on "cpu" the same function runs eagerly, which is how the
tests hold it bitwise to the granular loop. What the round computes
(classes, weights, missing and categorical routing, the eval step) is
decided by the config and the call, in Python, before the capture: the
graph holds no branch on a tensor value. A failed capture or replay
raises: the fused path never falls back to the granular loop or to the
CPU.

The mesh (cfg.world_size = host_partitions x n_partitions x
feature_partitions > 1, or one rank of a group of one; port of
TPUDevice's 2D mesh): in a process with an initialised torch.distributed
group of that many ranks, the backend binds to the rank's card
(cuda:<LOCAL_RANK>, or the CPU) and to its `Mesh` (parallel/mesh.
make_mesh_2d: the row, feature and world groups), and resolves
cfg.split_comms and cfg.hist_comms_slabs once. `world` and `rank` are
the row shards and this rank's row shard. `upload` and `upload_labels`
keep the rank's block of the padded rows (parallel/mesh.row_block; pad
rows weigh 0, so their g, h and loss vanish) and, with feature shards,
the rank's padded column slab of them (parallel/mesh.column_slab); a
RowBlock api.train binned on the device holds the block at full width
and loses its other columns here. An eval set is uploaded whole on every
rank (`shard=False`). Every collective of a round (the histogram
collective, node totals, winners, the routing broadcast, the
quantization statistics, the leaf sums, the loss) is an NCCL call on the
current stream, or on NCCL's own stream ordered by events when slabs are
pipelined, so the captured round holds them and each replay runs them:
every group's communicator exists before the capture, made by
make_mesh_2d, the bin-range check of `upload` and the warm-up round.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from ddt_tpu_torch import _build
from ddt_tpu_torch.backends.base import DeviceBackend, HostTree, unpack_tree
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.models.tree import CompiledEnsemble, TreeEnsemble
from ddt_tpu_torch.ops import grad as grad_ops
from ddt_tpu_torch.ops import grow as grow_ops
from ddt_tpu_torch.ops import histogram as hist_ops
from ddt_tpu_torch.ops import predict as predict_ops
from ddt_tpu_torch.ops import predict_lut, predict_lut_cuda, sampling
from ddt_tpu_torch.ops import split as split_ops
from ddt_tpu_torch.ops import stream as stream_ops
from ddt_tpu_torch.parallel import comms, mesh
from ddt_tpu_torch.robustness import faultplan
from ddt_tpu_torch.telemetry import counters as tele_counters
from ddt_tpu_torch.utils import launches, metrics, retry

log = logging.getLogger("ddt_tpu_torch.backends.cuda")

#: Round captures and replays since the last reset (chip_smoke reads them
#: around the main path).
graph_captures = 0
graph_replays = 0
#: Scoring operands built (`_scoring_operands`: the tier's tables
#: quantized, packed and uploaded), never reset: read its movement. A
#: model that owns its operands (ServableModel) builds them once.
operand_builds = 0


class LabelHandle(NamedTuple):
    """Labels on the device: the opaque `y` the Driver threads through
    grad_hess / loss_value (per-dataset state lives in handles, not on
    the backend, which is cached and shared). `valid` holds the instance
    weights (all ones without them), as the reference's handle does; it
    scales g and h and weights the loss only when `weighted`, so an
    unweighted round runs no extra kernel."""

    y: torch.Tensor         # f32 [R] (class ids for softmax)
    valid: torch.Tensor     # f32 [R] instance weights, or ones
    weighted: bool = False


class _Eval(NamedTuple):
    """An eval set inside a fused round: binned rows, margins (updated in
    place), labels and the metric's tensor twin."""

    data: torch.Tensor
    pred: torch.Tensor
    y: LabelHandle
    metric: str


def _pack(tree) -> torch.Tensor:
    """One [6, N] f32 record (base.PACKED_FIELDS) of a grown tree: a
    single device->host copy carries it."""
    return torch.stack([
        tree.feature.float(), tree.threshold_bin.float(),
        tree.is_leaf.float(), tree.leaf_value, tree.split_gain,
        tree.default_left.float()])


class ScoringOperands(NamedTuple):
    """One model's scoring operands, owned by its holder
    (CUDADevice.prepare_scoring): the compiled model, the tier's operands
    on the device and the tier ("lut4" | "lut" | "f32")."""

    compiled: CompiledEnsemble
    ops: Any
    tier: str


class CUDADevice(DeviceBackend):
    """Histogram-GBDT backend on PyTorch tensors: one device, or one rank
    of a hosts x rows x features mesh."""

    name = "cuda"
    PREDICT_CACHE_MAX = 4

    def __init__(self, cfg: TrainConfig,
                 device: torch.device | None = None):
        super().__init__(cfg)
        if cfg.device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the plain versions on the CPU")
        if cfg.world_size > 1:
            mesh.check_partitions(cfg)
        # A rank's scoring backend (one partition in a larger group)
        # binds no mesh and runs no collective. Driver.fit refuses to
        # train with a config whose mesh is not the world. `device` pins
        # one card of cfg.device's type (RowShardedScorer's shards).
        if device is not None:
            self.device = torch.device(device)
            if self.device.type != cfg.device:
                raise ValueError(f"device {self.device} is not of the "
                                 f"config's type {cfg.device!r}")
        else:
            self.device = (mesh.rank_device(cfg.device)
                           if mesh.is_initialized()
                           else torch.device(cfg.device))
        self.mesh = mesh.group_for(cfg)
        if self.mesh is not None:
            comms.check_group(self.device, self.mesh.world_group)
            self.group = self.mesh.row_group
            self.feature_group = self.mesh.feature_group
            self.world = self.mesh.row_shards
            self.rank = self.mesh.row_shard
        # Global width of the last matrix `upload` cut into a column slab.
        self._n_features: int | None = None
        self.split_comms = comms.resolve_split_comms(
            cfg.split_comms, row_shards=self.world)
        self.comms_slabs = comms.resolve_comms_slabs(
            cfg.hist_comms_slabs, distributed=self.mesh is not None,
            device_type=self.device.type)
        self.hist_subtraction = grow_ops.resolve_hist_subtraction(
            cfg.hist_subtraction, self.device.type,
            integer_hists=cfg.grad_dtype != "f32")
        #: This backend's histogram OOM ladder (ops/histogram): a step
        #: down stays with the backend, and no other backend sees it.
        self.hist_ladder = hist_ops.HistLadder(
            carry=self.hist_subtraction and self.mesh is None)
        # token -> (CompiledEnsemble, prepared operands), LRU order; and
        # token -> the tier those operands serve. Both under _cache_lock.
        self._predict_cache: dict[str, tuple] = {}
        self._predict_impl_resolved: dict[str, str] = {}
        self._cache_lock = threading.Lock()
        # F -> the bool [F] categorical mask, built once outside any
        # capture (building it copies from the host).
        self._cat_masks: dict[int, torch.Tensor | None] = {}
        # The captured round of the last fused block (one at a time) and
        # the host seconds its warm-up round and capture took.
        self._graph: _RoundGraph | None = None
        self._graph_lock = threading.Lock()
        self.last_capture_s: float | None = None
        # Pinned staging of streamed chunks (the card only; `stager`).
        self._stager: _ChunkStager | None = None
        #: The partition recorder's `span` factory while a granular fit
        #: records lanes (the Driver sets and clears it), else None.
        self.partition_span = None

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _tensor(self, a) -> torch.Tensor:
        return a if isinstance(a, torch.Tensor) else self._put(np.asarray(a))

    # ------------------------------------------------------------------ #
    # data plane
    # ------------------------------------------------------------------ #

    def device_rows(self, Xb) -> torch.Tensor:
        """Binned rows as a contiguous uint8 [R, F] tensor on the device: a
        tensor already there is taken as it is, anything else is copied
        once (a host array is type-checked before the copy)."""
        if not isinstance(Xb, torch.Tensor):
            Xb = np.asarray(Xb)
            if Xb.dtype != np.uint8 or Xb.ndim != 2:
                raise TypeError(
                    f"binned data must be uint8 [R, F], got {Xb.dtype} "
                    f"{Xb.shape}")
            return self._put(Xb)
        if Xb.dtype != torch.uint8 or Xb.dim() != 2:
            raise TypeError(
                f"binned data must be uint8 [R, F], got {Xb.dtype} "
                f"{tuple(Xb.shape)}")
        return Xb.to(self.device).contiguous()

    def collective_bytes_per_tree(self, n_features: int) -> int:
        """The histogram collectives' modeled payload of one tree per rank
        (comms.hist_allreduce_bytes at this backend's resolved comms and
        mesh); 0 without a group."""
        if self.mesh is None:
            return 0
        return comms.hist_allreduce_bytes(
            self.cfg.max_depth, n_features, self.cfg.n_bins,
            partitions=self.world,
            feature_partitions=self.mesh.n_feature_shards,
            mode=self.split_comms, comms_dtype=self.cfg.hist_comms_dtype,
            subtraction=self.hist_subtraction,
            grad_dtype=self.cfg.grad_dtype,
            value_bytes=8 if self.int64_wire else None)

    @property
    def int64_wire(self) -> bool:
        """Whether the exact path's aggregates cross the row group as
        int64 (cfg.straggler_repartition on an f32 wire: a reduction that
        does not depend on which rank holds which shard)."""
        cfg = self.cfg
        return (cfg.straggler_repartition and cfg.grad_dtype == "f32"
                and cfg.hist_comms_dtype == "f32")

    def n_features(self, data: torch.Tensor) -> int:
        """Global width of uploaded training rows: the matrix's before the
        column cut under feature shards, else data's own."""
        if self.feature_group is not None and self._n_features is not None:
            return self._n_features
        return data.shape[1]

    def _block(self, a, put) -> torch.Tensor:
        """This rank's padded block of the host array or tensor `a` ([R,
        ...]; only the block is copied), on the device through `put`."""
        a = a if isinstance(a, torch.Tensor) else np.asarray(a)
        start, stop, local = mesh.row_block(a.shape[0], self.world,
                                            self.rank)
        return mesh.pad_rows(put(a[start:stop]), local)

    def upload(self, Xb, shard: bool = True) -> torch.Tensor:
        """The binned matrix on the device (see device_rows), its bin range
        checked by one max on the device and one scalar read. On a mesh
        (and `shard`), this rank's padded block and, with feature shards,
        its padded column slab: a RowBlock (the block at full width) is
        taken, a whole matrix is cut to its block, and the block loses its
        other columns; the range check is then a MAX all-reduce over the
        world."""
        sharded = self.mesh is not None and shard
        if isinstance(Xb, mesh.RowBlock):
            if not sharded:
                raise ValueError("a RowBlock is one rank's rows: it needs "
                                 "a mesh and shard=True")
            local = mesh.row_block(Xb.n_rows, self.world, self.rank)[2]
            Xd = self.device_rows(Xb.rows)
            if Xd.shape[0] != local:
                raise ValueError(f"RowBlock holds {Xd.shape[0]} rows, this "
                                 f"rank's block of {Xb.n_rows} is {local}")
        elif sharded:
            Xd = self._block(Xb, self.device_rows)
        else:
            Xd = self.device_rows(Xb)
        if sharded:
            self._n_features = Xd.shape[1]
            if self.feature_group is not None:
                lo, hi, width = mesh.column_slab(
                    Xd.shape[1], self.mesh.n_feature_shards,
                    self.mesh.feature)
                Xd = mesh.pad_columns(Xd[:, lo:hi], width)
        top = (Xd.max() if Xd.numel() else torch.zeros(
            (), dtype=torch.uint8, device=self.device)).to(torch.int32)
        if sharded:
            top = comms.pmax(top.reshape(1), self.mesh.world_group)
        top = int(top.reshape(-1)[0])
        if top >= self.cfg.n_bins:
            raise ValueError(f"binned data holds bin {top} >= n_bins="
                             f"{self.cfg.n_bins}")
        return Xd

    def upload_labels(self, y: np.ndarray,
                      sample_weight: np.ndarray | None = None,
                      shard: bool = True) -> LabelHandle:
        """Labels, and the instance weights validated as the reference's
        Driver validates them (float [R], finite, >= 0, not all zero).
        On a mesh (and `shard`), this rank's padded row block (the same on
        every rank of its feature group), its pad rows weighing 0
        (weighted whenever the rows do not split evenly, on every rank
        alike)."""
        y = np.asarray(y, np.float32)
        w = None
        if sample_weight is not None:
            w = np.asarray(sample_weight, np.float32)
            if w.shape != y.shape:
                raise ValueError(f"sample_weight must be [R]={y.shape[0]}, "
                                 f"got {w.shape}")
            if not np.all(np.isfinite(w)) or (w < 0).any():
                raise ValueError("sample_weight must be finite and >= 0")
            if not (w > 0).any():
                raise ValueError("sample_weight is all zero")
        if self.mesh is None or not shard:
            if w is None:
                return LabelHandle(self._put(y), torch.ones(
                    y.shape[0], dtype=torch.float32, device=self.device))
            return LabelHandle(self._put(y), self._put(w), True)
        R = y.shape[0]
        valid = np.ones(R, np.float32) if w is None else w
        return LabelHandle(self._block(y, self._put),
                           self._block(valid, self._put),
                           w is not None or R % self.world != 0)

    def cat_mask(self, n_features: int) -> torch.Tensor | None:
        """The bool [F] mask of cfg.cat_features on the device (None
        without categorical features), built once per width."""
        if n_features not in self._cat_masks:
            self._cat_masks[n_features] = grow_ops.cat_feature_mask(
                self.cfg.cat_features, n_features, self.device)
        return self._cat_masks[n_features]

    # ------------------------------------------------------------------ #
    # granular kernels (parity surface)
    # ------------------------------------------------------------------ #

    def build_histograms(self, data, g, h, node_index, n_nodes):
        """f32 sums for float g/h, taken as training takes them: exact
        fixed-point sums on the grid of these g/h's global max
        (ops/histogram.build_histograms_exact), converted once; the raw
        int32 histogram for int8/int16 (quantized) g/h. On a mesh, of the
        row group's rows (an all-reduce on cfg.hist_comms_dtype's wire)
        over data's columns (this rank's slab under feature shards).
        Built through the `hist.build` seam (ops/histogram.build_table)
        and this backend's ladder's retry_build: no rung lowers a whole
        table, so only an injected fault is retried."""
        g, h = self._tensor(g), self._tensor(h)
        ni = self._tensor(node_index).to(torch.int32).contiguous()
        if g.is_floating_point():
            g, h = g.float().contiguous(), h.float().contiguous()
            scales = grad_ops.fixed_scales(
                comms.pmax(grad_ops.abs_max2(g, h), self.group),
                g.shape[0] * self.world)
            hist = grad_ops.from_fixed(self.hist_ladder.retry_build(
                lambda: hist_ops.build_table(data, g, h, ni, n_nodes,
                                             self.cfg.n_bins, scales)),
                scales)
        else:
            g, h = g.contiguous(), h.contiguous()
            hist = self.hist_ladder.retry_build(
                lambda: hist_ops.build_table(data, g, h, ni, n_nodes,
                                             self.cfg.n_bins))
        return comms.hist_reduce(hist, self.group, mode="allreduce",
                                 comms_dtype=self.cfg.hist_comms_dtype)

    def best_splits(self, hist):
        return split_ops.best_splits_impl(
            self._tensor(hist), self.cfg.reg_lambda,
            self.cfg.min_child_weight)[:3]

    # ------------------------------------------------------------------ #
    # training ops
    # ------------------------------------------------------------------ #

    def init_pred(self, y: LabelHandle, base: float) -> torch.Tensor:
        """[R] filled with `base`, or [R, C] for softmax (base 0)."""
        C = self.cfg.n_outputs
        shape = y.y.shape if C == 1 else (y.y.shape[0], C)
        return torch.full(shape, base, dtype=torch.float32,
                          device=self.device)

    def load_pred(self, raw: np.ndarray) -> torch.Tensor:
        return self._put(np.asarray(raw, np.float32))

    def grad_hess(self, pred, y: LabelHandle):
        """(g, h) f32 [R], or [R, C] for softmax, times the weights."""
        g, h = grad_ops.grad_hess(pred, y.y, self.cfg.loss)
        if y.weighted:
            v = y.valid[:, None] if g.dim() == 2 else y.valid
            g, h = g * v, h * v
        return g, h

    def apply_row_mask(self, g, h, mask):
        """Bagging: g and h ([R] or [R, C]) times the 0/1 row mask (bool
        [R], a tensor on the device or a host array), so a masked row adds
        nothing, and quantizes to a q of 0."""
        m = self._tensor(mask).to(torch.float32)
        if g.dim() == 2:
            m = m[:, None]
        return g * m, h * m

    def grow_tree(self, data, g, h, feature_mask=None,
                  tree_id: int = 0) -> tuple[Any, Any]:
        """Returns (packed [6, N] f32 tree on the device, delta [R]): no
        host sync here; `fetch_tree` copies the tree to the host.
        `feature_mask` (bool [F] over the global columns, host or device)
        is the colsample mask;
        `tree_id` (the absolute tree index) keys the quantized-gradient
        rounding with cfg.seed when cfg.grad_dtype != "f32"."""
        tree = self._grow(data, g, h, feature_mask, tree_id,
                          self.partition_span)
        return _pack(tree), grow_ops.tree_predict_delta(
            tree, self.cfg.learning_rate)

    def _grow(self, data, g, h, feature_mask, tree_id,
              span=None) -> grow_ops.TreeArrays:
        cfg = self.cfg
        if feature_mask is not None:
            feature_mask = self._tensor(feature_mask).to(torch.bool)
        F = self.n_features(data)
        return grow_ops.grow_tree(
            data, g.contiguous(), h.contiguous(),
            max_depth=cfg.max_depth, n_bins=cfg.n_bins,
            reg_lambda=cfg.reg_lambda,
            min_child_weight=cfg.min_child_weight,
            min_split_gain=cfg.min_split_gain,
            hist_subtraction=self.hist_subtraction,
            grad_dtype=cfg.grad_dtype, quant_tree_id=tree_id,
            quant_seed=cfg.seed, feature_mask=feature_mask,
            missing_bin=cfg.missing_policy == "learn",
            cat_mask=self.cat_mask(F), group=self.group,
            split_comms=self.split_comms,
            hist_comms_dtype=cfg.hist_comms_dtype,
            feature_group=self.feature_group,
            world_group=None if self.mesh is None
            else self.mesh.world_group,
            n_features=F, comms_slabs=self.comms_slabs,
            row_shard=self.rank if self.mesh is not None else None,
            shard_ordered=cfg.straggler_repartition, hist_span=span,
            ladder=self.hist_ladder)

    # ------------------------------------------------------------------ #
    # straggler rotation (the watchdog's action)
    # ------------------------------------------------------------------ #

    def rotate_row_partitions(self) -> bool:
        """Rotate the row shards one step around the row group (the
        straggler watchdog's action, the reference's
        TPUDevice.rotate_row_partitions): after the call, the rank at row
        position p holds shard p - 1 (mod the row shards), and `rank` (the
        shard this rank holds, which keys its bagging and rounding draws
        and its block of a newly uploaded matrix or chunk) says so. The
        caller moves every resident row block with reshard_rows /
        reshard_data at once: the shards' contents never change, so the
        model does not either. Returns False, and does nothing, without a
        mesh, with one row shard, or where the row axis spans hosts
        (host_partitions > 1), as the reference declines a mesh of many
        processes. Every rank of the mesh must call it in the same round
        (the Driver decides from lanes every rank holds)."""
        m = self.mesh
        if m is None or self.world < 2 or m.n_hosts > 1:
            return False
        self.rank = (self.rank - 1) % self.world
        log.info("rotated row partitions: rank at row %d holds shard %d",
                 m.row, self.rank)
        return True

    def reshard_rows(self, t: torch.Tensor | None, dim: int = 0):
        """After rotate_row_partitions: a resident row block (rows on
        `dim`, this rank's old shard) becomes the new shard's, by one
        ring shift over the row group (each rank sends its block to the
        next row position and receives the previous one's:
        dist.batch_isend_irecv). Blocks are equal-sized (mesh.row_block
        pads each to ceil(n / shards)), so the received block is copied
        into `t` in place and a captured graph or cached operand that
        holds `t` stays valid. Returns `t`."""
        if t is None or self.mesh is None or self.world < 2:
            return t
        import torch.distributed as dist

        group = self.group
        me, P = comms.rank(group), self.world
        send = t.movedim(dim, 0).contiguous()
        recv = torch.empty_like(send)
        peer = (dist.get_global_rank(group, (me + 1) % P) if group
                is not None else (me + 1) % P)
        src = (dist.get_global_rank(group, (me - 1) % P) if group
               is not None else (me - 1) % P)
        ops = [dist.P2POp(dist.isend, send, peer, group),
               dist.P2POp(dist.irecv, recv, src, group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        t.copy_(recv.movedim(0, dim))
        return t

    def reshard_data(self, data: torch.Tensor | None):
        """reshard_rows for the binned matrix (its column slab stays
        where it is: the shift runs along the row axis of each feature
        column)."""
        return self.reshard_rows(data)

    def reshard_labels(self, y: "LabelHandle | None"):
        """reshard_rows for a LabelHandle (labels and weights)."""
        if y is None:
            return None
        self.reshard_rows(y.y)
        self.reshard_rows(y.valid)
        return y

    def fetch_tree(self, handle) -> HostTree:
        """One packed tree to the host, through the `fetch_tree` retry
        seam (a transient fault of the copy is retried; the handle is
        unchanged, so a second read gives the same tree)."""
        return retry.retry_call(self._fetch_tree, handle, seam="fetch_tree")

    @staticmethod
    def _fetch_tree(handle) -> HostTree:
        faultplan.inject("fetch_tree")
        return unpack_tree(handle.cpu().numpy())

    def fetch_grown_tree(self, tree: grow_ops.TreeArrays) -> HostTree:
        """A finished tree's node arrays on the host (the streamed
        trainer's trees), packed into one device->host copy."""
        return self.fetch_tree(_pack(tree))

    def apply_delta(self, pred, delta, class_idx: int):
        """pred + delta, into column class_idx of an [R, C] pred."""
        if pred.dim() == 1:
            if class_idx != 0:
                raise ValueError(f"class {class_idx} of a one-column pred")
            return pred + delta
        out = pred.clone()
        out[:, class_idx] += delta
        return out

    def _loss(self, pred, y: LabelHandle) -> torch.Tensor:
        return grad_ops.mean_loss(pred, y.y, self.cfg.loss,
                                  y.valid if y.weighted else None,
                                  group=self.group)

    def loss_value(self, pred, y: LabelHandle) -> float:
        return float(self._loss(pred, y))

    def _route(self, ev: _Eval, tree, class_idx: int) -> None:
        """Add one tree (TreeArrays, or a packed [6, N] record) to the eval
        margins in place."""
        if isinstance(tree, torch.Tensor):
            tree = grow_ops.TreeArrays(
                tree[0].to(torch.int32), tree[1].to(torch.int32),
                tree[2] > 0.5, tree[3], tree[4], tree[5] > 0.5, None)
        cfg = self.cfg
        grow_ops.apply_tree_pred(
            ev.data, ev.pred, tree.feature, tree.threshold_bin,
            tree.is_leaf, tree.leaf_value,
            tree.default_left if cfg.missing_policy == "learn" else None,
            max_depth=cfg.max_depth, learning_rate=cfg.learning_rate,
            class_idx=class_idx, missing_bin_value=cfg.missing_bin_value,
            cat_mask=self.cat_mask(ev.data.shape[1]))

    @staticmethod
    def _score(ev: _Eval) -> torch.Tensor:
        fn = metrics.device_metric(ev.metric, n_classes=(
            ev.pred.shape[1] if ev.pred.dim() == 2 else 1))
        if fn is None:
            raise ValueError(f"metric {ev.metric!r} has no device twin "
                             "for these margins")
        return fn(ev.y.y, ev.pred)

    def eval_round(self, val_data, val_pred, handles, val_y: LabelHandle,
                   metric: str):
        """Add one round's trees (a packed handle per class, from
        grow_tree) to the eval-set margins: (new margins, the metric as an
        f32 0-dim device tensor). `val_pred` itself is left as it was."""
        ev = _Eval(val_data, val_pred.clone(), val_y, metric)
        for c, handle in enumerate(handles):
            self._route(ev, handle, c)
        return ev.pred, self._score(ev)

    # ------------------------------------------------------------------ #
    # fused rounds
    # ------------------------------------------------------------------ #

    def _round(self, data, pred, y: LabelHandle, rnd: torch.Tensor,
               fmasks: torch.Tensor | None, ev: _Eval | None = None):
        """One boosting round, every per-round input read from a tensor
        (`rnd`: 0-dim int64 absolute round, the bagging and rounding key;
        `fmasks`: bool [C, F] colsample masks or None). Grows one tree per
        output column c from the round's gradients (quantization tree id
        rnd * C + c) and adds each to column c of `pred` in place, and,
        with `ev`, to the eval margins. Returns (packed trees [6, N], or
        [C, 6, N]; mean loss after the round; the eval metric or None).
        The granular loop's steps in its order, so its trees are the
        granular loop's bit for bit wherever the device's sums are
        deterministic."""
        cfg = self.cfg
        C = cfg.n_outputs
        g, h = self.grad_hess(pred, y)
        if cfg.subsample < 1.0:
            R = pred.shape[0]
            keep = sampling.row_keep(cfg.seed, rnd, self.row_start(R), R,
                                     cfg.subsample, device=pred.device)
            g, h = self.apply_row_mask(g, h, keep)
        if C > 1:
            # [C, R]: each class's column reaches the kernel contiguous.
            g, h = g.t().contiguous(), h.t().contiguous()
        packs = []
        for c in range(C):
            tree = self._grow(
                data, g[c] if C > 1 else g, h[c] if C > 1 else h,
                None if fmasks is None else fmasks[c],
                rnd * C + c if C > 1 else rnd)
            delta = grow_ops.tree_predict_delta(tree, cfg.learning_rate)
            (pred[:, c] if C > 1 else pred).add_(delta)
            if ev is not None:
                self._route(ev, tree, c)
            packs.append(_pack(tree))
        trees = torch.stack(packs) if C > 1 else packs[0]
        return (trees, self._loss(pred, y),
                None if ev is None else self._score(ev))

    def grow_rounds(self, data, pred, y: LabelHandle, n_rounds: int,
                    first_round: int = 0):
        """n_rounds boosting rounds from the absolute round first_round:
        (packed trees [n_rounds, 6, N] or [n_rounds, C, 6, N], new pred,
        losses [n_rounds]), all on the device. `pred` itself is left as it
        was."""
        return self._grow_rounds(data, pred, y, n_rounds, first_round,
                                 None)[:3]

    def _fmasks(self, data, n_rounds: int, fmasks) -> torch.Tensor:
        """Host colsample masks, bool [n_rounds, C, F] ([n_rounds, F] with
        one class), checked and uploaded once."""
        fm = np.asarray(fmasks, bool)
        C, F = self.cfg.n_outputs, self.n_features(data)
        if fm.ndim == 2 and C == 1:
            fm = fm[:, None, :]
        if fm.shape != (n_rounds, C, F):
            raise ValueError(f"fmasks must be [{n_rounds}, {C}, {F}], got "
                             f"{np.asarray(fmasks).shape}")
        return self._put(fm)

    def grow_rounds_masked(self, data, pred, y: LabelHandle, n_rounds: int,
                           fmasks: np.ndarray, first_round: int = 0):
        """grow_rounds with one host-drawn colsample mask a round and
        class, bool [n_rounds, C, F] ([n_rounds, F] with one class)."""
        return self._grow_rounds(data, pred, y, n_rounds, first_round,
                                 self._fmasks(data, n_rounds, fmasks))[:3]

    def grow_rounds_eval(self, data, pred, y: LabelHandle, n_rounds: int,
                         val_data, val_pred, val_y: LabelHandle,
                         metric: str, first_round: int = 0,
                         fmasks: np.ndarray | None = None):
        """grow_rounds with the eval set scored inside the round: each
        tree is added to the eval margins as it is grown and the metric's
        tensor twin takes the round's score. Returns (trees, new pred,
        losses, new eval margins, scores [n_rounds] f32), all on the
        device; `pred` and `val_pred` are left as they were."""
        fm = None if fmasks is None else self._fmasks(data, n_rounds, fmasks)
        return self._grow_rounds(data, pred, y, n_rounds, first_round, fm,
                                 _Eval(val_data, val_pred, val_y, metric))

    def _grow_rounds(self, data, pred, y, n_rounds, first_round, fmasks,
                     ev=None):
        if n_rounds < 1:
            raise ValueError(f"n_rounds must be >= 1, got {n_rounds}")
        if self.device.type == "cuda":
            with self._graph_lock:
                key = _RoundGraph.key_of(data, pred, y, fmasks is not None,
                                         ev)
                if self._graph is None or self._graph.key != key:
                    self._graph = None          # frees the old pool first
                    self._graph = _RoundGraph(self, data, pred, y,
                                              fmasks is not None, ev)
                    self.last_capture_s = self._graph.capture_s
                return self._graph.run(pred, n_rounds, first_round, fmasks,
                                       None if ev is None else ev.pred)
        pred = pred.clone()
        if ev is not None:
            ev = ev._replace(pred=ev.pred.clone())
        trees, losses, scores = [], [], []
        for k in range(n_rounds):
            rnd = torch.tensor(first_round + k, dtype=torch.int64)
            tree, loss, score = self._round(
                data, pred, y, rnd, None if fmasks is None else fmasks[k],
                ev)
            trees.append(tree)
            losses.append(loss)
            scores.append(score)
        out = (torch.stack(trees), pred, torch.stack(losses))
        if ev is None:
            return out
        return out + (ev.pred, torch.stack(scores))

    def fetch_rounds(self, trees, losses, scores=None) -> tuple:
        """One device->host copy for a block's trees and losses (and eval
        scores, when given): (trees, losses[, scores]) as host arrays."""
        n, k = trees.numel(), losses.numel()
        parts = [trees.reshape(-1), losses.float()]
        if scores is not None:
            parts.append(scores.float())
        flat = torch.cat(parts).cpu().numpy()
        out = (flat[:n].reshape(tuple(trees.shape)), flat[n:n + k])
        return out if scores is None else out + (flat[n + k:],)

    # ------------------------------------------------------------------ #
    # streaming (streaming.fit_streaming / predict_streaming)
    # ------------------------------------------------------------------ #

    @property
    def stager(self) -> "_ChunkStager | None":
        """The pinned staging of streamed chunks on the card, made at first
        use (None on the CPU)."""
        if self._stager is None and self.device.type == "cuda":
            self._stager = _ChunkStager(self.device)
        return self._stager

    def block_bounds(self, n_rows: int) -> tuple[int, int, int]:
        """(start, stop, local) of this rank's block of an n_rows chunk:
        the padded row block of parallel/mesh.row_block."""
        if self.mesh is None:
            return 0, n_rows, n_rows
        return mesh.row_block(n_rows, self.world, self.rank)

    def chunk_row_start(self, chunk_start: int, n_rows: int) -> int:
        """Global id of this rank's first row of a chunk whose first row
        is global row `chunk_start`: the bagging and rounding draws' base
        (pad rows past the chunk carry zero weight)."""
        return chunk_start + self.block_bounds(n_rows)[0]

    def upload_chunk(self, Xc, keep: bool = False) -> torch.Tensor:
        """A streamed chunk's binned rows (uint8 [r, F], a host array or a
        tensor, pinned or not) on the device: this rank's padded block
        on a mesh. On the card through the double-buffered pinned staging
        on a side stream (`_ChunkStager`): the copy of the next chunk
        runs under the current chunk's kernels, and the returned tensor
        is a staging buffer, valid until the upload after next, unless
        `keep` (a tensor of its own, for the chunk cache). Counts the
        block's bytes, padding included, in telemetry's h2d_bytes. Bin
        ranges are the caller's to check (check_bins)."""
        if not isinstance(Xc, torch.Tensor):
            Xc = np.asarray(Xc)
        start, stop, local = self.block_bounds(Xc.shape[0])
        return self._upload_block(Xc[start:stop], local, keep)

    def _upload_block(self, block, local: int, keep: bool) -> torch.Tensor:
        """This rank's rows of a chunk (`local` rows with its padding) on
        the device; see upload_chunk."""
        if self.feature_group is not None:
            raise NotImplementedError(
                "the streamed trainer is row-parallel only: "
                "feature_partitions > 1 does not stream")
        if block.dtype not in (np.uint8, torch.uint8) or block.ndim != 2:
            raise TypeError(f"binned chunks must be uint8 [r, F], got "
                            f"{block.dtype} {tuple(block.shape)}")
        tele_counters.record_h2d(local * block.shape[1])
        if self.device.type != "cuda":
            out = torch.zeros((local, block.shape[1]), dtype=torch.uint8)
            out[:block.shape[0]] = (block if isinstance(block, torch.Tensor)
                                    else torch.from_numpy(
                                        np.ascontiguousarray(block)))
            return out
        return self.stager.put(block, local, keep)

    def upload_row_shards(self, parts: list, total_rows: int,
                          keep: bool = False) -> torch.Tensor:
        """A host-sharded chunk (data/chunks.HostShardedChunks): `parts`
        are the sub-shards this process owns, in order, which together
        must be exactly this rank's rows of the chunk; uploaded as
        upload_chunk uploads the rank's block, other ranks' rows never
        read. One process: the parts are the whole chunk."""
        rows = (np.concatenate(parts) if len(parts) > 1
                else np.asarray(parts[0]))
        start, stop, local = self.block_bounds(total_rows)
        if rows.shape[0] != stop - start:
            raise ValueError(
                f"rank {self.rank} owns {rows.shape[0]} rows of this "
                f"chunk but its block is {stop - start}; host-sharded "
                "chunks need sub-shards that cut at the ranks' blocks "
                "(one process a rank, uniform sub-shard sizes)")
        return self._upload_block(rows, local, keep)

    def check_bins(self, data: torch.Tensor) -> None:
        """Raise when an uploaded chunk holds a bin >= n_bins: one device
        max and one scalar read (a MAX all-reduce over the world on a
        mesh), as `upload` checks."""
        top = (data.max() if data.numel() else torch.zeros(
            (), dtype=torch.uint8, device=self.device)).to(torch.int32)
        if self.mesh is not None:
            top = comms.pmax(top.reshape(1), self.mesh.world_group)
        top = int(top.reshape(-1)[0])
        if top >= self.cfg.n_bins:
            raise ValueError(f"binned data holds bin {top} >= n_bins="
                             f"{self.cfg.n_bins}")

    def _chunk_grads(self, pred, y: LabelHandle, class_idx: int, rnd: int,
                     row_start: int):
        cfg = self.cfg
        keep = None
        if cfg.subsample < 1.0:
            keep = sampling.row_keep(cfg.seed, rnd, row_start,
                                     pred.shape[0], cfg.subsample,
                                     device=pred.device)
        return stream_ops.chunk_grads(pred, y.y, y.valid, y.weighted,
                                      cfg.loss, class_idx, keep)

    def _tree_id(self, rnd: int, class_idx: int) -> int:
        C = self.cfg.n_outputs
        return rnd * C + class_idx if C > 1 else rnd

    def stream_values(self, pred, y: LabelHandle, class_idx: int, rnd: int,
                      row_start: int, scales, ints: bool = True):
        """What one chunk's rows add for class `class_idx`: on the exact
        path (scales: f32 [2] 2^k) the f32 (g, h), or with `ints` their
        int64 rint(g * 2^k); under quantized gradients (scales: the
        round's (gscale, hscale)) the int8/int16 q's."""
        cfg = self.cfg
        g, h = self._chunk_grads(pred, y, class_idx, rnd, row_start)
        if cfg.grad_dtype == "f32":
            if not ints:
                return g, h
            return grad_ops.to_fixed(g, scales[0]), \
                grad_ops.to_fixed(h, scales[1])
        return grad_ops.quantize_with_scales(
            g, h, scales[0], scales[1], grad_dtype=cfg.grad_dtype,
            tree_id=self._tree_id(rnd, class_idx), seed=cfg.seed,
            row_start=row_start)

    def stream_level_hist(self, data, pred, y: LabelHandle, tree,
                          depth: int, out: torch.Tensor, class_idx: int = 0,
                          rnd: int = 0, row_start: int = 0,
                          build_left: bool = False, scales=None):
        """Add one uploaded chunk's level-`depth` histogram of class
        `class_idx` into `out` (int64 [2^depth, F, B, 2] on the exact
        path, int32 under quantized gradients; [2^(depth-1), ...] LEFT
        children with `build_left`). `tree` is the partial tree's
        (feature, threshold_bin, is_leaf, default_left) on the device;
        `scales` the tree's (ops/grad.fixed_scales, or the quantized
        (gscale, hscale)); `rnd` / `row_start` key the bagging and
        rounding draws. The rank-local table: the trainer reduces it over
        the row group once a level."""
        cfg = self.cfg
        g, h = self.stream_values(pred, y, class_idx, rnd, row_start,
                                  scales, ints=False)
        return stream_ops.stream_level_hist(
            data, g, h, tree, depth, out, n_bins=cfg.n_bins,
            scales=scales if cfg.grad_dtype == "f32" else None,
            build_left=build_left, missing_bin_value=cfg.missing_bin_value,
            cat_mask=self.cat_mask(data.shape[1]), ladder=self.hist_ladder)

    def stream_leaf_gh(self, data, pred, y: LabelHandle, tree,
                       out: torch.Tensor, class_idx: int = 0, rnd: int = 0,
                       row_start: int = 0, scales=None) -> torch.Tensor:
        """Add one chunk's final-level (G, H) integer sums into `out`
        [2^max_depth, 2] (int64, or int32 quantized); returns the rows'
        leaf slots (int32 [R])."""
        cfg = self.cfg
        qg, qh = self.stream_values(pred, y, class_idx, rnd, row_start,
                                    scales)
        return stream_ops.stream_leaf_gh(
            data, qg, qh, tree, cfg.max_depth, out,
            missing_bin_value=cfg.missing_bin_value,
            cat_mask=self.cat_mask(data.shape[1]))

    def stream_grad_stats(self, pred, y: LabelHandle, rnd: int = 0,
                          row_start: int = 0) -> torch.Tensor:
        """One chunk's per-class statistics, no chunk read: f32 [C, 2]
        max |g|, |h| (the exact path's scales) or [C, 4] with the sums
        (quantized gradients)."""
        return stream_ops.stream_grad_stats(
            self._class_grads(pred, y, rnd, row_start),
            self.cfg.grad_dtype == "f32")

    def _class_grads(self, pred, y, rnd, row_start) -> list:
        return [self._chunk_grads(pred, y, c, rnd, row_start)
                for c in range(self.cfg.n_outputs)]

    def stream_round_start(self, pred, y: LabelHandle, slots, leaf_values,
                           rnd: int = 0, row_start: int = 0
                           ) -> torch.Tensor:
        """The previous round's trees added to pred (in place) from the
        resident leaf slots ([C, R] int32; leaf_values: an f32 [N] tensor
        a class), then the new round's stream_grad_stats: no chunk read
        (ops/stream.stream_round_start)."""
        return stream_ops.stream_round_start(
            pred, slots, leaf_values, self.cfg.learning_rate,
            lambda p: self._class_grads(p, y, rnd, row_start),
            self.cfg.grad_dtype == "f32")

    def stream_update_pred(self, data, pred, tree_full,
                           class_idx: int = 0) -> None:
        """pred += one finished tree's lr * leaf value per row of `data`,
        in place (tree_full: feature, threshold_bin, is_leaf, leaf_value,
        default_left, host arrays or tensors)."""
        cfg = self.cfg
        feat, thr, leaf, val, dl = (self._tensor(a) for a in tree_full)
        stream_ops.stream_update_pred(
            data, pred, feat, thr, leaf, val,
            dl if cfg.missing_policy == "learn" else None,
            max_depth=cfg.max_depth, learning_rate=cfg.learning_rate,
            class_idx=class_idx, missing_bin_value=cfg.missing_bin_value,
            cat_mask=self.cat_mask(data.shape[1]))

    def score_device(self, ens: TreeEnsemble, Xd: torch.Tensor,
                     compiled=None, operands=None) -> torch.Tensor:
        """Raw margins of uploaded binned rows, left on the device (the
        tier predict_raw serves). `operands` (prepare_scoring's) score
        without the backend's cache."""
        if operands is None:
            ce, ops = self._prepared(ens, compiled)
        else:
            ce, ops = operands.compiled, operands.ops
        if isinstance(ops, predict_lut.LutOperands):
            return ops.score(Xd)
        return predict_ops.predict_prepared(
            ops, Xd, learning_rate=ce.learning_rate, base=ce.base_score,
            tree_chunk=ce.tree_chunk, missing_bin_value=ce.missing_bin_value)

    # ------------------------------------------------------------------ #
    # inference
    # ------------------------------------------------------------------ #

    def resolved_predict_impl(self, token: str) -> str:
        """The scoring tier that serves model `token` after the ladder
        ("lut4" | "lut" | "f32"; "f32" when the model never scored
        here)."""
        with self._cache_lock:
            return self._predict_impl_resolved.get(token, "f32")

    def _smem_limit(self) -> int:
        if self.device.type == "cuda":
            return _build.smem_limit(self.device)
        return predict_lut_cuda.SMEM_LIMIT_H100

    def _lut_operands(self, ce: CompiledEnsemble, n_features: int,
                      tier: str):
        """The quantized tier `tier` ("lut" int8, "lut4" int4) of one
        model on the device, or None when that kernel's fits guard
        refuses the shape (the caller walks the ladder down)."""
        if tier == "lut4":
            tables = ce.quantize(leaf_dtype="int4")
            packed = tables.pack_int4()
            if not predict_lut.predict_lut4_fits(
                    tables.n_trees_padded, tables.tree_chunk,
                    tables.max_depth, n_features, tables.n_classes_out,
                    smem_limit=self._smem_limit(),
                    thr_packed=packed.thr_packed):
                return None
            host_ops, static = packed.ops, packed.static_kwargs()
        else:
            tables = ce.quantize()
            if not predict_lut.predict_lut_fits(
                    tables.n_trees_padded, tables.tree_chunk,
                    tables.max_depth, n_features, tables.n_classes_out,
                    smem_limit=self._smem_limit(),
                    leaf_dtype=tables.leaf_dtype):
                return None
            host_ops = predict_lut.lut_device_operands(tables)
            static = predict_lut.lut_static_kwargs(tables)
        # What the kernel would otherwise derive per call, once per model.
        n_int = (1 << tables.max_depth) - 1
        static.update(
            cls=self._put(tables.cls_oh.argmax(axis=1).astype(np.int32)),
            max_feature=int(tables.eff_feat[:, :n_int].max()))
        return predict_lut.LutOperands(
            tier, tuple(self._put(a) for a in host_ops), static)

    def _scoring_operands(self, ce: CompiledEnsemble, n_features: int):
        """(operands, tier): the reference's ladder (TPUDevice._predict_fn)
        int4 -> int8 -> f32, each step taken only when the fits guard
        refuses the shape, decided before any launch. Counted in
        `operand_builds`."""
        global operand_builds
        operand_builds += 1
        impl = self.cfg.predict_impl
        lut = None
        if impl == "lut4":
            lut = self._lut_operands(ce, n_features, "lut4")
            if lut is None:
                log.warning(
                    "predict_impl='lut4': shape exceeds the int4 kernel's "
                    "shared memory; falling back to the int8 LUT tier")
        if lut is None and impl in ("lut", "lut4"):
            lut = self._lut_operands(ce, n_features, "lut")
            if lut is None:
                log.warning(
                    "predict_impl=%r: shape exceeds the LUT kernel's "
                    "shared memory; falling back to the f32 path", impl)
        if lut is not None:
            return lut, lut.tier
        return predict_ops.prepare(
            self._put(ce.eff_feat), self._put(ce.eff_thr),
            self._put(ce.bot_val), self._put(ce.cls_oh),
            max_depth=ce.max_depth,
            eff_dl=None if ce.eff_dl is None else self._put(ce.eff_dl),
            eff_cat=None if ce.eff_cat is None
            else self._put(ce.eff_cat)), "f32"

    def _prepared(self, ens: TreeEnsemble,
                  compiled: CompiledEnsemble | None):
        """(CompiledEnsemble, its scoring operands on the device: the
        serving tier's LutOperands, or predict.prepare's f32 operands),
        cached per model. The lock makes lookups and inserts atomic, so
        a swap warming a new model on one thread and a dispatcher scoring
        on another share the cache; operands are built outside it."""
        token = compiled.token if compiled is not None \
            else ens.cache_token()
        with self._cache_lock:
            hit = self._predict_cache.pop(token, None)
            if hit is not None:
                self._predict_cache[token] = hit    # most recently used
                tele_counters.record_compiled_ensemble_hit()
                return hit
        ce = compiled if compiled is not None else ens.compile(
            tree_chunk=64)
        ops, tier = self._scoring_operands(ce, ens.n_features)
        hit = (ce, ops)
        with self._cache_lock:
            self._predict_cache[token] = hit
            self._predict_impl_resolved[token] = tier
            while len(self._predict_cache) > self.PREDICT_CACHE_MAX:
                gone = next(iter(self._predict_cache))
                self._predict_cache.pop(gone)
                self._predict_impl_resolved.pop(gone, None)
        return hit

    def prepare_scoring(self, ens: TreeEnsemble,
                        compiled: CompiledEnsemble | None = None
                        ) -> "ScoringOperands":
        """One model's scoring operands on the device at the tier the
        ladder resolves, built now and kept by the caller, never put in
        the backend's cache (see the module docstring)."""
        ce = compiled if compiled is not None else ens.compile(
            tree_chunk=64)
        ops, tier = self._scoring_operands(ce, ens.n_features)
        with self._cache_lock:
            self._predict_impl_resolved[ce.token] = tier
        return ScoringOperands(ce, ops, tier)

    def predict_raw(self, ens: TreeEnsemble, Xb, compiled=None,
                    operands: "ScoringOperands | None" = None
                    ) -> np.ndarray:
        """Raw margins of binned rows as a host array: through `operands`
        (prepare_scoring's) when given, else the backend's cache."""
        Xd = self.device_rows(Xb)
        return self.score_device(ens, Xd, compiled,
                                 operands).cpu().numpy()


class RowShardedScorer:
    """f32 scoring of one batch over k devices in one process (port of
    ddt_tpu/api.py's `_row_mesh_backend`, which row-shards a batch over a
    1-D mesh): the rows are split into `parallel/mesh.row_block` blocks,
    block i goes to shard i (a CUDADevice on cuda:i, or on the CPU for
    every block with device="cpu"), trees are replicated (each shard
    keeps its own copy of the scoring tables, keyed on the model's token)
    and no collective runs. On the cards each block is uploaded, binned
    (ops/quantize) and scored by K3 on its card's own stream, and its
    margins copied on that stream into its rows of one pinned host
    buffer; every card is launched before any is synchronized. A row's
    margin depends on its row alone, so the result is bitwise one
    device's."""

    def __init__(self, n_partitions: int, device: str = "cuda"):
        if n_partitions < 1:
            raise ValueError(f"n_partitions must be >= 1, got "
                             f"{n_partitions}")
        cfg = TrainConfig(device=device)
        if device == "cuda":
            visible = (torch.cuda.device_count()
                       if torch.cuda.is_available() else 0)
            if n_partitions > visible:
                raise ValueError(
                    f"n_partitions={n_partitions} but only {visible} "
                    "CUDA cards visible")
            devices = [torch.device("cuda", i) for i in range(n_partitions)]
        else:
            devices = [torch.device(device)] * n_partitions
        self.n_partitions = n_partitions
        self.device = devices[0]
        self.shards = [CUDADevice(cfg, device=d) for d in devices]
        self.streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                        for d in devices]

    def predict_raw(self, ens: TreeEnsemble, X, mapper=None) -> np.ndarray:
        """Raw margins of X: float rows binned with `mapper` on each
        shard's device, uint8 bins (host array or tensor) without one, or
        a list of binned blocks already on the shards' devices (block i a
        uint8 tensor on shard i's), joined in order."""
        if isinstance(X, (list, tuple)):
            if len(X) != self.n_partitions:
                raise ValueError(f"{len(X)} blocks for "
                                 f"{self.n_partitions} shards")
            R = sum(b.shape[0] for b in X)

            def rows(i, be):
                return X[i]
        else:
            R = X.shape[0]

            def rows(i, be):
                start, stop, _ = mesh.row_block(R, self.n_partitions, i)
                return (mapper.transform_device(X[start:stop], be.device)
                        if mapper is not None
                        else be.device_rows(X[start:stop]))
        ce = self._compiled(ens)
        out = _Joined(R)
        start = 0
        for i, be in enumerate(self.shards):
            stream = self.streams[i]
            if stream is not None:
                # Rows already on the card may still be in flight on its
                # current stream.
                stream.wait_stream(torch.cuda.current_stream(be.device))
            with _on_stream(stream):
                Xd = rows(i, be)
                out.put(start, be.score_device(ens, Xd, compiled=ce))
            start += Xd.shape[0]
        return self._join(out)

    def _compiled(self, ens: TreeEnsemble) -> CompiledEnsemble:
        """The model's CompiledEnsemble from shard 0's cache: one content
        hash of the ensemble a call, whose token then keys every shard's
        tables."""
        return self.shards[0]._prepared(ens, None)[0]

    def _join(self, out: "_Joined") -> np.ndarray:
        for stream in self.streams:
            if stream is not None:
                stream.synchronize()
        return out.host.numpy()


class _Joined:
    """The margins of every block in one host buffer (pinned when they
    come from a card), each block copied into its rows on the current
    stream, unsynchronized: no concatenation after the last block."""

    def __init__(self, n_rows: int):
        self.n_rows = n_rows
        self.host: torch.Tensor | None = None

    def put(self, start: int, block: torch.Tensor) -> None:
        if self.host is None:
            self.host = torch.empty((self.n_rows, *block.shape[1:]),
                                    dtype=block.dtype,
                                    pin_memory=block.is_cuda)
        self.host[start:start + block.shape[0]].copy_(
            block, non_blocking=block.is_cuda)


def _on_stream(stream):
    """torch.cuda.stream(stream) on a card; no context on the CPU."""
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


class _ChunkStager:
    """Double-buffered pinned staging of streamed chunks on a side stream.

    `put(rows, local, keep)` takes this rank's block of a chunk (a host
    array, or a tensor: a pinned one is copied from as it is) and returns
    it on the card as [local, F] uint8, zero pad rows below. A pageable
    block is first copied into one of two pinned host buffers (host
    staging; the buffer's previous transfer is waited for first); the
    transfer runs on the side stream, which waits until the compute
    stream is done with the device buffer it overwrites (the event
    recorded at the upload after that buffer's chunk), and the compute
    stream waits for the transfer. The next chunk's host staging and
    transfer thus run while the current chunk's kernels do. `keep`
    transfers into a tensor of its own (the chunk cache) instead of a
    staging buffer; the side stream then waits for the compute stream,
    which is the cached chunk's one upload.

    Measures, while `timing` is set: host staging seconds and the
    transfers' device milliseconds (event pairs on the side stream)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.side = torch.cuda.Stream(device)
        self.host = [None, None]        # pinned uint8 buffers
        self.dev = [None, None]         # device uint8 buffers
        self.src = [None, None]         # the source a transfer reads
        self.copied = [None, None]      # transfer-done events
        self.used = [None, None]        # compute-done events
        self.i = 0
        self.last = None                # the slot of the previous put
        self.timing = False
        self.stage_s = 0.0
        self._events: list = []

    def stats(self) -> dict:
        """{"stage_s", "h2d_ms", "transfers"} since the last reset_stats
        (synchronises on the recorded transfers)."""
        ms = 0.0
        for a, b in self._events:
            b.synchronize()
            ms += a.elapsed_time(b)
        return {"stage_s": self.stage_s, "h2d_ms": ms,
                "transfers": len(self._events)}

    def reset_stats(self) -> None:
        self.stage_s, self._events = 0.0, []

    def put(self, rows, local: int, keep: bool) -> torch.Tensor:
        cur = torch.cuda.current_stream(self.device)
        if self.last is not None:
            # Everything queued so far read the previous slot's buffer.
            ev = torch.cuda.Event()
            ev.record(cur)
            self.used[self.last] = ev
        k = self.i
        self.i ^= 1
        n, F = rows.shape[0], rows.shape[1]
        nbytes = local * F
        if self.copied[k] is not None:
            self.copied[k].synchronize()    # the pinned buffer is free
        self.src[k] = None
        if isinstance(rows, torch.Tensor) and rows.device.type == "cuda":
            src = rows.contiguous()
            self.side.wait_stream(cur)
        elif isinstance(rows, torch.Tensor) and rows.is_pinned():
            src = rows.contiguous()
        else:
            t0 = time.perf_counter()
            if self.host[k] is None or self.host[k].numel() < n * F:
                self.host[k] = torch.empty(max(n * F, 1), dtype=torch.uint8,
                                           pin_memory=True)
            src = self.host[k][:n * F].view(n, F)
            # torch's copy spreads a large copy over the intra-op threads.
            src.copy_(rows if isinstance(rows, torch.Tensor)
                      else torch.from_numpy(np.ascontiguousarray(rows)))
            if self.timing:
                self.stage_s += time.perf_counter() - t0
        if keep:
            dst = torch.empty((local, F), dtype=torch.uint8,
                              device=self.device)
            self.side.wait_stream(cur)
        else:
            if self.dev[k] is None or self.dev[k].numel() < nbytes:
                if self.used[k] is not None:
                    self.used[k].synchronize()
                self.dev[k] = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                                          device=self.device)
            dst = self.dev[k][:nbytes].view(local, F)
            if self.used[k] is not None:
                self.side.wait_event(self.used[k])
        with torch.cuda.stream(self.side):
            if self.timing:
                a = torch.cuda.Event(enable_timing=True)
                a.record(self.side)
            dst[:n].copy_(src, non_blocking=True)
            if local > n:
                dst[n:].zero_()
            if self.timing:
                b = torch.cuda.Event(enable_timing=True)
                b.record(self.side)
                self._events.append((a, b))
            done = torch.cuda.Event()
            done.record(self.side)
        self.copied[k] = done
        self.src[k] = src
        cur.wait_event(done)
        if keep:
            dst.record_stream(self.side)
            self.last = None
        else:
            self.last = k
        return dst


class _RoundGraph:
    """One boosting round (CUDADevice._round) captured as a CUDA graph for
    one key, replayed once a round.

    Static inputs: `pred` (the boosting state, which the round updates in
    place), `rnd` (0-dim int64 round), when masked `fmask` (bool [C, F]),
    and with an eval set its margins `vpred`. Before each block the
    caller's pred (and margins) are copied in, before each replay the
    round and masks; each replay's trees, loss and score are copied into
    the block's slot k, so a block ends in one device->host fetch.
    Nothing per round is a python value baked into the graph.

    The key is what the graph reads where it lies: the data's, labels'
    and weights' addresses, shapes and strides, pred's shape, and with
    an eval set its rows', labels' and metric's (its margins are copied
    into the graph's own buffer, so their address is not read). A new
    dataset or eval set at other addresses recaptures; the config is the
    backend's own."""

    def __init__(self, backend: CUDADevice, data: torch.Tensor,
                 pred: torch.Tensor, y: LabelHandle, masked: bool,
                 ev: _Eval | None):
        global graph_captures
        dev = data.device
        R, F = data.shape[0], backend.n_features(data)
        C = backend.cfg.n_outputs
        self.key = self.key_of(data, pred, y, masked, ev)
        self.pred = torch.zeros_like(pred)
        self.rnd = torch.zeros((), dtype=torch.int64, device=dev)
        self.fmask = (torch.ones((C, F), dtype=torch.bool, device=dev)
                      if masked else None)
        self.ev = None if ev is None else ev._replace(
            pred=torch.zeros_like(ev.pred))
        t0 = time.perf_counter()
        # One round outside the graph first: it loads the kernels'
        # libraries, plans their launches, queries occupancy, sets their
        # shared-memory attribute and builds the categorical mask, none of
        # which may happen inside a capture. Its launches run, so they
        # count.
        backend._round(data, self.pred, y, self.rnd, self.fmask, self.ev)
        torch.cuda.synchronize(dev)
        ladder = backend.hist_ladder
        while True:
            # An allocation failure inside the capture steps the backend's
            # OOM ladder and re-raises (ops/histogram.HistLadder.run): the
            # graph, which holds the failed attempt's work, is dropped with
            # its recording and memory pool, and the round captured again
            # at the new rung.
            rung = ladder.rung
            self.graph = torch.cuda.CUDAGraph()
            try:
                with launches.recording() as rec, torch.cuda.graph(
                        self.graph, capture_error_mode="thread_local"):
                    self.tree, self.loss, self.score = backend._round(
                        data, self.pred, y, self.rnd, self.fmask, self.ev)
                break
            except Exception:
                if ladder.rung == rung:
                    raise
                del self.graph
                log.warning("round capture abandoned after an allocation "
                            "failure; capturing again at %s",
                            hist_ops.rung_name(ladder.rung))
        torch.cuda.synchronize(dev)
        self.recording = rec
        self.capture_s = time.perf_counter() - t0
        graph_captures += 1
        tele_counters.graph_captured(self.capture_s)
        log.info("captured a boosting round (%d rows x %d features, %d "
                 "trees%s) in %.1f ms", R, F, C,
                 "" if ev is None else ", eval", 1e3 * self.capture_s)

    @staticmethod
    def _where(t: torch.Tensor) -> tuple:
        return (t.data_ptr(), tuple(t.shape), t.stride())

    @classmethod
    def key_of(cls, data: torch.Tensor, pred: torch.Tensor, y: LabelHandle,
               masked: bool, ev: _Eval | None) -> tuple:
        key = (data.device, cls._where(data), tuple(pred.shape),
               cls._where(y.y), cls._where(y.valid), y.weighted, masked)
        if ev is None:
            return key
        return key + (cls._where(ev.data), tuple(ev.pred.shape),
                      cls._where(ev.y.y), ev.metric)

    def run(self, pred: torch.Tensor, n_rounds: int, first_round: int,
            fmasks: torch.Tensor | None, vpred: torch.Tensor | None = None):
        global graph_replays
        dev = self.pred.device
        trees = torch.empty((n_rounds,) + tuple(self.tree.shape),
                            dtype=torch.float32, device=dev)
        losses = torch.empty(n_rounds, dtype=torch.float32, device=dev)
        scores = (None if self.ev is None else
                  torch.empty(n_rounds, dtype=torch.float32, device=dev))
        self.pred.copy_(pred)
        if self.ev is not None:
            self.ev.pred.copy_(vpred)
        for k in range(n_rounds):
            self.rnd.fill_(first_round + k)
            if fmasks is not None:
                self.fmask.copy_(fmasks[k])
            self.graph.replay()
            trees[k].copy_(self.tree)
            losses[k].copy_(self.loss)
            if scores is not None:
                scores[k].copy_(self.score)
            self.recording.replayed()
            graph_replays += 1
        out = (trees, self.pred.clone(), losses)
        if self.ev is None:
            return out
        return out + (self.ev.pred.clone(), scores)
