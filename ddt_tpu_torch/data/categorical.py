"""Sparse categorical features -> the <=255-bin path (the Criteo config).

Port of ddt_tpu/data/categorical.py (numpy, copied so the port depends on
nothing of the JAX package; the same bins for the same ids, and
CategoricalEncoder.save()/load() dicts cross-load with the reference's):

- frequency binning (default): per column, the (n_bins - 1) most frequent
  category ids each get a bin, ranked by frequency (rank 0 = most
  frequent -> bin 1); everything else, the sparse tail, shares bin 0;
- hash binning: stateless `id % n_bins` after a Fibonacci mix, for
  streams where a frequency pass is impossible.

The bins are category ids: train with these columns in
TrainConfig.cat_features for one-vs-rest splits ("bin == k goes left"),
or ordinally (then a split means "head categories vs tail").
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CategoricalEncoder:
    """Per-column frequency-rank vocabularies, serializable."""

    vocab_ids: list[np.ndarray]    # per column: int64 ids, rank order
    n_bins: int

    def transform(self, X_cat: np.ndarray) -> np.ndarray:
        """int64 category ids [R, C] → uint8 bins [R, C] (0 = tail/unknown)."""
        X_cat = np.asarray(X_cat)
        out = np.zeros(X_cat.shape, np.uint8)
        for c, vocab in enumerate(self.vocab_ids):
            # rank+1 for known ids, 0 for tail. searchsorted over the sorted
            # vocab gives the position; map back to frequency rank.
            order = np.argsort(vocab, kind="stable")
            sorted_ids = vocab[order]
            pos = np.searchsorted(sorted_ids, X_cat[:, c])
            pos = np.clip(pos, 0, len(sorted_ids) - 1)
            hit = sorted_ids[pos] == X_cat[:, c]
            rank = order[pos]
            out[:, c] = np.where(hit, rank + 1, 0).astype(np.uint8)
        return out

    def save(self) -> dict:
        d = {"n_bins": np.int64(self.n_bins),
             "n_cols": np.int64(len(self.vocab_ids))}
        for c, v in enumerate(self.vocab_ids):
            d[f"vocab_{c}"] = v
        return d

    @staticmethod
    def load(d: dict) -> "CategoricalEncoder":
        n_cols = int(d["n_cols"])
        return CategoricalEncoder(
            vocab_ids=[np.asarray(d[f"vocab_{c}"], np.int64)
                       for c in range(n_cols)],
            n_bins=int(d["n_bins"]),
        )


def fit_categorical_encoder(
    X_cat: np.ndarray, n_bins: int = 255
) -> CategoricalEncoder:
    """Build per-column frequency vocabularies of size ≤ n_bins − 1."""
    X_cat = np.asarray(X_cat)
    vocabs = []
    for c in range(X_cat.shape[1]):
        ids, counts = np.unique(X_cat[:, c], return_counts=True)
        # Stable frequency order: by (-count, id) so ties are deterministic.
        order = np.lexsort((ids, -counts))
        vocabs.append(ids[order][: n_bins - 1].astype(np.int64))
    return CategoricalEncoder(vocab_ids=vocabs, n_bins=n_bins)


def bin_categoricals(X_cat: np.ndarray, n_bins: int = 255) -> np.ndarray:
    """fit + transform convenience (single-pass frequency binning)."""
    return fit_categorical_encoder(X_cat, n_bins=n_bins).transform(X_cat)


def hash_bin_categoricals(X_cat: np.ndarray, n_bins: int = 255) -> np.ndarray:
    """Stateless hash binning for streaming: (id * φ-mix) % n_bins.

    Fibonacci-hash style mixing so adjacent ids don't collide into adjacent
    bins; pure function of the id, usable chunk-by-chunk at 10B-row scale.
    """
    X_cat = np.asarray(X_cat).astype(np.uint64)
    mixed = (X_cat * np.uint64(11400714819323198485)) >> np.uint64(40)
    return (mixed % np.uint64(n_bins)).astype(np.uint8)
