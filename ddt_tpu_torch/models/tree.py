"""TreeEnsemble: structure-of-arrays boosted ensemble, host side.

Port of ddt_tpu/models/tree.py (numpy). This is where model parameters
cross between the packages: `TreeEnsemble.from_dict` accepts exactly what
the reference's `to_dict()` returns, and `save`/`load` write and read the
same npz layout, in both directions.

Heap layout: a tree of `max_depth` split levels occupies 2^(max_depth+1)-1
node slots; node i's children are 2i+1 (left) and 2i+2 (right). Leaves are
marked `is_leaf` and traversal freezes there. A binned row goes LEFT iff
bin[feature] <= threshold_bin (categorical nodes: iff bin == threshold).
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from ddt_tpu_torch.utils.atomic import atomic_savez


@dataclasses.dataclass
class TreeEnsemble:
    """Boosted ensemble as stacked per-tree arrays, [n_trees, n_nodes_total]
    each. For softmax models tree t scores class t % n_classes (round
    t // n_classes)."""

    feature: np.ndarray        # int32  [T, N] split feature (-1 on leaves)
    threshold_bin: np.ndarray  # int32  [T, N] split bin (go left if <=)
    threshold_raw: np.ndarray  # float32 [T, N] raw-value threshold
    is_leaf: np.ndarray        # bool   [T, N]
    leaf_value: np.ndarray     # float32 [T, N]
    split_gain: np.ndarray     # float32 [T, N] gain of the split (0 on leaves)
    max_depth: int
    n_features: int
    learning_rate: float
    base_score: float          # raw-score offset
    loss: str                  # logloss | mse | softmax
    n_classes: int = 2
    has_raw_thresholds: bool = False  # True once a BinMapper filled them
    default_left: np.ndarray | None = None   # bool [T, N] NaN-row direction
    missing_bin: bool = False  # True: bin n_bins-1 is the NaN bin
    n_bins: int = 0            # binning width the model was trained with
    cat_features: np.ndarray | None = None   # int32, sorted

    @property
    def n_trees(self) -> int:
        return int(self.feature.shape[0])

    @property
    def n_nodes_total(self) -> int:
        return int(self.feature.shape[1])

    @property
    def has_cat_splits(self) -> bool:
        return self.cat_features is not None and len(self.cat_features) > 0

    def cache_token(self) -> str:
        """Content digest of everything device scoring depends on: the key
        of the backends' compiled-ensemble cache (trainers mutate the node
        arrays in place, so identity cannot key it)."""
        h = hashlib.sha1()
        for a in (self.feature, self.threshold_bin, self.is_leaf,
                  self.leaf_value):
            h.update(np.ascontiguousarray(a).tobytes())
        if self.default_left is not None:
            h.update(np.ascontiguousarray(self.default_left).tobytes())
        if self.has_cat_splits:
            h.update(np.ascontiguousarray(self.cat_features).tobytes())
        h.update(repr((self.max_depth, self.learning_rate, self.base_score,
                       self.loss, self.n_classes, self.missing_bin,
                       self.n_bins)).encode())
        return h.hexdigest()

    def compile(self, tree_chunk: int = 64) -> "CompiledEnsemble":
        """Host-side compiled scoring layout (see CompiledEnsemble)."""
        return CompiledEnsemble.build(self, tree_chunk=tree_chunk)

    # ------------------------------------------------------------------ #
    # NumPy prediction (oracle-grade; the device path is ops/predict.py)
    # ------------------------------------------------------------------ #

    def _traverse_np(self, X: np.ndarray, binned: bool) -> np.ndarray:
        """Leaf index per (tree, row): int32 [T, R]."""
        if not binned and not self.has_raw_thresholds:
            raise ValueError(
                "Ensemble has no raw-value thresholds (trained without a "
                "BinMapper); predict on binned data with binned=True, or "
                "train with a mapper first."
            )
        T = self.n_trees
        R = X.shape[0]
        node = np.zeros((T, R), dtype=np.int64)
        thr = self.threshold_bin if binned else self.threshold_raw
        Xc = X.astype(np.int32) if binned else X.astype(np.float32)
        use_missing = self.missing_bin and self.default_left is not None
        use_cat = self.has_cat_splits
        for _ in range(self.max_depth):
            feat = np.take_along_axis(self.feature, node, axis=1)
            t = np.take_along_axis(thr, node, axis=1)
            leaf = np.take_along_axis(self.is_leaf, node, axis=1)
            fv = np.stack([Xc[np.arange(R), np.maximum(feat[k], 0)]
                           for k in range(T)])
            go_right = fv > t
            if use_cat:
                # One-vs-rest: the matched category goes left (categorical
                # columns hold bin ids in both representations).
                tb = np.take_along_axis(self.threshold_bin, node, axis=1)
                go_right = np.where(np.isin(feat, self.cat_features),
                                    fv != tb, go_right)
            if use_missing:
                dl = np.take_along_axis(self.default_left, node, axis=1)
                miss = (fv == self.n_bins - 1) if binned else np.isnan(fv)
                go_right = np.where(miss, ~dl, go_right)
            nxt = 2 * node + 1 + go_right
            node = np.where(leaf, node, nxt)
        return node.astype(np.int32)

    def aggregate_leaves(self, leaf_idx: np.ndarray) -> np.ndarray:
        """Raw scores from leaf indices [T, R]: lr scale, base score, and
        the softmax tree-to-class interleave (tree t scores class t % C)."""
        vals = np.take_along_axis(self.leaf_value, leaf_idx.astype(np.int64),
                                  axis=1)               # [T, R]
        vals = vals * self.learning_rate
        if self.loss == "softmax":
            C = self.n_classes
            R = leaf_idx.shape[1]
            out = np.full((R, C), self.base_score, dtype=np.float32)
            for t in range(self.n_trees):
                out[:, t % C] += vals[t]
            return out
        return (self.base_score + vals.sum(axis=0)).astype(np.float32)

    def predict_raw(self, X: np.ndarray, binned: bool = False) -> np.ndarray:
        """Raw (margin) scores. Binary/regression: [R]; softmax: [R, C]."""
        return self.aggregate_leaves(self._traverse_np(X, binned=binned))

    def predict_raw_roundwise(self, X: np.ndarray,
                              binned: bool = False) -> np.ndarray:
        """predict_raw in the fit loop's own f32 order: the base, then one
        sequential add of lr * leaf per tree, in tree order (predict_raw's
        pairwise vals.sum differs in ULPs). Checkpoint resume rebuilds the
        boosting state with it, so a resumed run is bitwise an
        uninterrupted one."""
        leaf_idx = self._traverse_np(X, binned=binned)
        if self.loss == "softmax":
            # aggregate_leaves' softmax branch already adds tree by tree.
            return self.aggregate_leaves(leaf_idx)
        vals = np.take_along_axis(self.leaf_value,
                                  leaf_idx.astype(np.int64), axis=1)
        vals = (vals * self.learning_rate).astype(np.float32)
        out = np.full((leaf_idx.shape[1],), self.base_score, np.float32)
        for t in range(self.n_trees):
            out += vals[t]
        return out

    def predict(self, X: np.ndarray, binned: bool = False) -> np.ndarray:
        """Probability predictions (or raw values for mse)."""
        raw = self.predict_raw(X, binned=binned)
        if self.loss == "logloss":
            return 1.0 / (1.0 + np.exp(-raw))
        if self.loss == "softmax":
            z = raw - raw.max(axis=1, keepdims=True)
            e = np.exp(z)
            return e / e.sum(axis=1, keepdims=True)
        return raw

    # ------------------------------------------------------------------ #
    # Inspection and LightGBM interop
    # ------------------------------------------------------------------ #

    def feature_importances(self, kind: str = "split") -> np.ndarray:
        """Normalized per-feature importance, float32 [n_features]:
        kind="split" the share of split nodes using the feature, "gain"
        its share of the total split gain (LightGBM's importance_type)."""
        mask = (~self.is_leaf) & (self.feature >= 0)
        used = self.feature[mask]
        if kind == "split":
            w = np.ones(used.shape[0])
        elif kind == "gain":
            w = self.split_gain[mask].astype(np.float64)
        else:
            raise ValueError(f"unknown importance kind {kind!r}")
        counts = np.bincount(used, weights=w, minlength=self.n_features)
        counts = counts[: self.n_features].astype(np.float64)
        tot = counts.sum()
        return (counts / tot if tot > 0 else counts).astype(np.float32)

    def dump(self, tree: int) -> dict:
        """One tree as nested plain-Python dicts. Split nodes:
        {"split": {"feature", "bin", "threshold" (raw value, or None
        without raw thresholds), "gain"}, "left", "right"}; leaves:
        {"leaf": value}."""
        t = int(tree)

        def node(i: int) -> dict:
            if self.is_leaf[t, i] or self.feature[t, i] < 0:
                return {"leaf": float(self.leaf_value[t, i])}
            return {
                "split": {
                    "feature": int(self.feature[t, i]),
                    "bin": int(self.threshold_bin[t, i]),
                    "threshold": (
                        float(self.threshold_raw[t, i])
                        if self.has_raw_thresholds else None
                    ),
                    "gain": float(self.split_gain[t, i]),
                },
                "left": node(2 * i + 1),
                "right": node(2 * i + 2),
            }

        return node(0)

    def dump_text(self, tree: int) -> str:
        """Indented text rendering of one tree."""
        lines: list[str] = []

        def walk(d: dict, depth: int) -> None:
            pad = "  " * depth
            if "leaf" in d:
                lines.append(f"{pad}leaf={d['leaf']:+.6f}")
                return
            s = d["split"]
            thr = (f" (<= {s['threshold']:.6g})"
                   if s["threshold"] is not None else "")
            lines.append(
                f"{pad}f{s['feature']} <= bin {s['bin']}{thr}  "
                f"gain={s['gain']:.4g}"
            )
            walk(d["left"], depth + 1)
            walk(d["right"], depth + 1)

        walk(self.dump(tree), 0)
        return "\n".join(lines)

    def to_lightgbm_text(self, feature_names: list[str] | None = None
                         ) -> str:
        """LightGBM model.txt rendering (models/lightgbm_io.py)."""
        from ddt_tpu_torch.models.lightgbm_io import to_lightgbm_text

        return to_lightgbm_text(self, feature_names=feature_names)

    @staticmethod
    def from_lightgbm_text(text: str) -> "TreeEnsemble":
        """Parse a LightGBM model.txt (models/lightgbm_io.py)."""
        from ddt_tpu_torch.models.lightgbm_io import from_lightgbm_text

        return from_lightgbm_text(text)

    # ------------------------------------------------------------------ #
    # Serialization: the reference's npz layout
    # ------------------------------------------------------------------ #

    def to_dict(self) -> dict:
        return {
            "feature": self.feature,
            "threshold_bin": self.threshold_bin,
            "threshold_raw": self.threshold_raw,
            "is_leaf": self.is_leaf,
            "leaf_value": self.leaf_value,
            "split_gain": self.split_gain,
            "default_left": self._dl(),
            "max_depth": np.int64(self.max_depth),
            "n_features": np.int64(self.n_features),
            "learning_rate": np.float64(self.learning_rate),
            "base_score": np.float64(self.base_score),
            "loss": np.bytes_(self.loss.encode()),
            "n_classes": np.int64(self.n_classes),
            "has_raw_thresholds": np.bool_(self.has_raw_thresholds),
            "missing_bin": np.bool_(self.missing_bin),
            "n_bins": np.int64(self.n_bins),
            "categorical_features": (
                self.cat_features if self.cat_features is not None
                else np.zeros(0, np.int32)
            ),
        }

    @staticmethod
    def from_dict(d: dict) -> "TreeEnsemble":
        """Accepts the reference's to_dict() (and the npz it saves; extra
        keys such as its embedded manifest are ignored)."""
        return TreeEnsemble(
            feature=np.asarray(d["feature"], np.int32),
            threshold_bin=np.asarray(d["threshold_bin"], np.int32),
            threshold_raw=np.asarray(d["threshold_raw"], np.float32),
            is_leaf=np.asarray(d["is_leaf"], bool),
            leaf_value=np.asarray(d["leaf_value"], np.float32),
            split_gain=np.asarray(
                d["split_gain"] if "split_gain" in d
                else np.zeros_like(d["leaf_value"]),
                np.float32),
            default_left=(
                np.asarray(d["default_left"], bool)
                if "default_left" in d
                else np.zeros(np.asarray(d["is_leaf"]).shape, bool)
            ),
            max_depth=int(d["max_depth"]),
            n_features=int(d["n_features"]),
            learning_rate=float(d["learning_rate"]),
            base_score=float(d["base_score"]),
            loss=bytes(d["loss"]).decode(),
            n_classes=int(d["n_classes"]),
            has_raw_thresholds=bool(d.get("has_raw_thresholds", False)),
            missing_bin=bool(d.get("missing_bin", False)),
            n_bins=int(d.get("n_bins", 0)),
            cat_features=(
                np.asarray(d["categorical_features"], np.int32)
                if "categorical_features" in d
                and np.asarray(d["categorical_features"]).size
                else None
            ),
        )

    def save(self, path: str) -> None:
        """Atomic, byte-deterministic npz in the reference's layout, with
        the embedded `tree_ensemble` manifest (registry/manifest.py):
        `load` ignores it, api.load_model digest-verifies it."""
        from ddt_tpu_torch.registry import manifest as manifest_mod

        d = self.to_dict()
        manifest_mod.embed_npz_manifest(d, kind="tree_ensemble")
        atomic_savez(path, compressed=True, deterministic=True, **d)

    @staticmethod
    def load(path: str) -> "TreeEnsemble":
        with np.load(path) as d:
            return TreeEnsemble.from_dict(dict(d))

    def _dl(self) -> np.ndarray:
        return (self.default_left if self.default_left is not None
                else np.zeros_like(self.is_leaf))

    def truncate(self, n_trees: int) -> "TreeEnsemble":
        """First `n_trees` trees."""
        return dataclasses.replace(
            self,
            feature=self.feature[:n_trees],
            threshold_bin=self.threshold_bin[:n_trees],
            threshold_raw=self.threshold_raw[:n_trees],
            is_leaf=self.is_leaf[:n_trees],
            leaf_value=self.leaf_value[:n_trees],
            split_gain=self.split_gain[:n_trees],
            default_left=self._dl()[:n_trees],
        )

    @staticmethod
    def concat(ensembles: list["TreeEnsemble"]) -> "TreeEnsemble":
        """Stack ensembles trained one after the other (the first one's
        scalars are kept)."""
        head = ensembles[0]
        return dataclasses.replace(
            head,
            feature=np.concatenate([e.feature for e in ensembles]),
            threshold_bin=np.concatenate([e.threshold_bin
                                          for e in ensembles]),
            threshold_raw=np.concatenate([e.threshold_raw
                                          for e in ensembles]),
            is_leaf=np.concatenate([e.is_leaf for e in ensembles]),
            leaf_value=np.concatenate([e.leaf_value for e in ensembles]),
            split_gain=np.concatenate([e.split_gain for e in ensembles]),
            default_left=np.concatenate([e._dl() for e in ensembles]),
        )


def _effective_arrays_np(feature, thr, is_leaf, leaf_value, max_depth):
    """Leaf-chain pushdown: (eff_feat, eff_thr, eff_val) with every node
    below a leaf inheriting the leaf's value, leaf/inherited nodes carrying
    feature=-1 and thr=+BIG. Pure integer/copy selects."""
    big = (np.asarray(np.inf, thr.dtype)
           if np.issubdtype(thr.dtype, np.floating)
           else np.asarray(2 ** 30, thr.dtype))
    eff_feat = np.where(is_leaf, np.int32(-1), feature).astype(np.int32)
    eff_thr = np.where(is_leaf, big, thr).astype(thr.dtype)
    eff_val = np.array(leaf_value, np.float32)
    chained = np.array(is_leaf, bool)
    for d in range(1, max_depth + 1):
        lo, hi = (1 << d) - 1, (1 << (d + 1)) - 1
        par = (np.arange(lo, hi) - 1) // 2
        pch = chained[:, par]
        eff_feat[:, lo:hi] = np.where(pch, -1, eff_feat[:, lo:hi])
        eff_thr[:, lo:hi] = np.where(pch, big, eff_thr[:, lo:hi])
        eff_val[:, lo:hi] = np.where(pch, eff_val[:, par],
                                     eff_val[:, lo:hi])
        chained[:, lo:hi] = pch | is_leaf[:, lo:hi]
    return eff_feat, eff_thr, eff_val


@dataclasses.dataclass(frozen=True)
class CompiledEnsemble:
    """Binned scoring layout of one model: pushdown applied, trees padded
    to a tree_chunk multiple, class one-hot built. ops/predict consumes
    these arrays; backends keep device copies keyed on `token`."""

    token: str                 # TreeEnsemble.cache_token() at build time
    tree_chunk: int
    max_depth: int
    n_classes_out: int         # C: softmax n_classes, else 1
    learning_rate: float
    base_score: float
    loss: str
    missing_bin_value: int     # reserved NaN bin id, -1 = no missing
    eff_feat: np.ndarray       # int32 [Tpad, N] pushed-down
    eff_thr: np.ndarray        # int32 [Tpad, N] pushed-down (bins)
    bot_val: np.ndarray        # float32 [Tpad, 2^D] bottom-level values
    cls_oh: np.ndarray         # float32 [Tpad, C] round-major class 1-hot
    eff_dl: np.ndarray | None  # bool [Tpad, N] or None
    eff_cat: np.ndarray | None  # bool [Tpad, N] or None

    @property
    def n_trees_padded(self) -> int:
        return int(self.eff_feat.shape[0])

    def arrays(self) -> tuple:
        """Operand tuple in predict_raw_effective's argument order (the
        optional masks appended when present)."""
        out = [self.eff_feat, self.eff_thr, self.bot_val, self.cls_oh]
        if self.eff_dl is not None:
            out.append(self.eff_dl)
        if self.eff_cat is not None:
            out.append(self.eff_cat)
        return tuple(out)

    def quantize(self, leaf_dtype: str = "float16"):
        """TreeLUT-style quantized scoring tables
        (ops/predict_lut.QuantizedTables): int8 recentred thresholds,
        fp16 / int8 / int4 leaves, and the computed `max_abs_err` bound.
        Memoized per leaf_dtype (this snapshot is immutable): the serving
        tier quantizes at publish and the backend at its first quantized
        dispatch, one host pass shared."""
        memo = self.__dict__.get("_quant_memo")
        if memo is None:
            memo = {}
            object.__setattr__(self, "_quant_memo", memo)
        if leaf_dtype not in memo:
            from ddt_tpu_torch.ops.predict_lut import quantize_compiled

            memo[leaf_dtype] = quantize_compiled(self, leaf_dtype=leaf_dtype)
        return memo[leaf_dtype]

    def seed_quantized(self, tables) -> None:
        """Install pre-built tables as this instance's quantization:
        `quantize(leaf_dtype=tables.leaf_dtype)`, the backend's first
        quantized dispatch included, returns them verbatim (tables carried
        with a model, e.g. loaded with ops/predict_lut.tables_from_arrays,
        serve as they are)."""
        memo = self.__dict__.get("_quant_memo")
        if memo is None:
            memo = {}
            object.__setattr__(self, "_quant_memo", memo)
        memo[tables.leaf_dtype] = tables

    @staticmethod
    def build(ens: TreeEnsemble, tree_chunk: int = 64
              ) -> "CompiledEnsemble":
        T, N = ens.feature.shape
        n_tc = -(-T // tree_chunk)
        tpad = n_tc * tree_chunk - T

        def pad_t(a, fill=0):
            return np.pad(a, ((0, tpad), (0, 0)), constant_values=fill)

        # Padded trees are all-leaf at the root with value 0: they add
        # exactly 0.0 to their class column.
        ef, et, ev = _effective_arrays_np(
            pad_t(ens.feature, -1).astype(np.int32),
            pad_t(ens.threshold_bin).astype(np.int32),
            pad_t(ens.is_leaf, True), pad_t(ens.leaf_value),
            ens.max_depth,
        )
        C = ens.n_classes if ens.loss == "softmax" else 1
        lo = (1 << ens.max_depth) - 1
        cls = np.arange(n_tc * tree_chunk, dtype=np.int64) % C
        cls_oh = np.zeros((n_tc * tree_chunk, C), np.float32)
        cls_oh[np.arange(len(cls)), cls] = 1.0
        use_missing = ens.missing_bin and ens.default_left is not None
        eff_dl = pad_t(ens.default_left) if use_missing else None
        eff_cat = (pad_t(np.isin(ens.feature, ens.cat_features))
                   if ens.has_cat_splits else None)
        return CompiledEnsemble(
            token=ens.cache_token(), tree_chunk=tree_chunk,
            max_depth=ens.max_depth, n_classes_out=C,
            learning_rate=float(ens.learning_rate),
            base_score=float(ens.base_score), loss=ens.loss,
            missing_bin_value=(ens.n_bins - 1 if use_missing else -1),
            eff_feat=ef, eff_thr=et,
            bot_val=np.ascontiguousarray(ev[:, lo:]),
            cls_oh=cls_oh, eff_dl=eff_dl, eff_cat=eff_cat,
        )


def empty_ensemble(
    n_trees: int,
    max_depth: int,
    n_features: int,
    learning_rate: float,
    base_score: float,
    loss: str,
    n_classes: int = 2,
    missing_bin: bool = False,
    n_bins: int = 0,
    cat_features: tuple = (),
) -> TreeEnsemble:
    n_nodes = 2 ** (max_depth + 1) - 1
    return TreeEnsemble(
        feature=np.full((n_trees, n_nodes), -1, np.int32),
        threshold_bin=np.zeros((n_trees, n_nodes), np.int32),
        threshold_raw=np.zeros((n_trees, n_nodes), np.float32),
        is_leaf=np.zeros((n_trees, n_nodes), bool),
        leaf_value=np.zeros((n_trees, n_nodes), np.float32),
        split_gain=np.zeros((n_trees, n_nodes), np.float32),
        default_left=np.zeros((n_trees, n_nodes), bool),
        max_depth=max_depth,
        n_features=n_features,
        learning_rate=learning_rate,
        base_score=base_score,
        loss=loss,
        n_classes=n_classes,
        missing_bin=missing_bin,
        n_bins=n_bins,
        cat_features=(np.asarray(cat_features, np.int32)
                      if cat_features else None),
    )
