"""Hierarchical BoW vocabulary as dense tensors.

Port of ``airslam_tpu/loopclosure/vocabulary.py`` (which replaces DBoW2's
``TemplatedVocabulary`` and the ``FSuperpoint`` adapter:
mean descriptor + squared-L2 distance):

- the k-ary tree of depth L is stored as per-level centroid tensors
  ``levels[l]: (k^l, k, D)``; transforming N descriptors is L batched
  gather + distance-argmin steps on the vocabulary's device, in float32;
  the distance is the summed squared difference ``((c − d)²).sum(−1)``, as
  the JAX package computes it (the ``|c|² + |d|² − 2c·d`` expansion rounds
  differently and flips near-ties), with TF32 off;
- training is hierarchical k-means (k-means++ seeding, Lloyd iterations) in
  numpy, copied as it is, so the same seed gives the same tree bit for bit;
- scoring is DBoW2's L1 score over L1-normalized TF-IDF vectors.

``save``/``load`` read and write the JAX package's ``.npz`` layout.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from airslam_tpu_torch.backend.gn import full_f32


class Vocabulary:
    """k-ary hierarchical vocabulary with TF-IDF weights and L1 scoring.
    ``device``: where :meth:`transform` runs (the CPU unless given)."""

    def __init__(self, levels: List[np.ndarray], weights: np.ndarray,
                 valid: Optional[List[np.ndarray]] = None, device="cpu"):
        """levels[l]: (k^l, k, D) float32 centroids; weights: (k^L,) idf.
        valid[l]: (k^l, k) bool — child-exists masks for under-full nodes."""
        self.device = torch.device(device)
        self.levels = [torch.as_tensor(np.asarray(l, np.float32), device=self.device)
                       for l in levels]
        self.weights = torch.as_tensor(np.asarray(weights, np.float32), device=self.device)
        self.k = int(np.asarray(levels[0]).shape[1])
        self.depth = len(levels)
        self.num_words = int(self.k ** self.depth)
        if valid is None:
            valid = [np.ones(np.asarray(l).shape[:2], bool) for l in levels]
        self.valid = [torch.as_tensor(np.asarray(v, bool), device=self.device) for v in valid]

    # -- transform ----------------------------------------------------------

    def _transform(self, desc: torch.Tensor, mask: torch.Tensor):
        """desc: (N, D) float32; returns (word_ids (N,), word_weight (N,))."""
        n = desc.shape[0]
        node = torch.zeros(n, dtype=torch.int64, device=desc.device)
        inf = torch.tensor(float("inf"), dtype=desc.dtype, device=desc.device)
        for l in range(self.depth):
            cents = self.levels[l][node]  # (N, k, D)
            vmask = self.valid[l][node]  # (N, k)
            d2 = ((cents - desc[:, None, :]) ** 2).sum(-1)
            d2 = torch.where(vmask, d2, inf)
            node = node * self.k + torch.argmin(d2, dim=-1)
        wids = torch.where(mask, node, torch.full_like(node, -1))
        w = torch.where(mask, self.weights[node], torch.zeros_like(self.weights[node]))
        return wids, w

    def transform(self, desc, mask=None):
        """Numpy in/out: descriptors (N, 256) → (word_ids int32, weights f32)."""
        desc = np.asarray(desc, np.float32)
        if mask is None:
            mask = np.ones(len(desc), bool)
        with full_f32():
            wids, w = self._transform(torch.as_tensor(desc, device=self.device),
                                      torch.as_tensor(np.asarray(mask, bool), device=self.device))
        return wids.cpu().numpy().astype(np.int32), w.cpu().numpy()

    def bow_vector(self, desc, mask=None):
        """L1-normalized TF-IDF BowVector as {word_id: weight} + per-feature
        word ids (the FrameToBow contract, database.cc:58-91)."""
        wids, w = self.transform(desc, mask)
        vec = {}
        for wid, wt in zip(wids, w):
            if wid < 0 or wt <= 0:
                continue
            vec[int(wid)] = vec.get(int(wid), 0.0) + float(wt)
        total = sum(vec.values())
        if total > 0:
            vec = {k: v / total for k, v in vec.items()}
        return vec, wids

    # -- scoring ------------------------------------------------------------

    @staticmethod
    def score_l1(v1: dict, v2: dict) -> float:
        """DBoW2's L1 score, halved into [0, 1]: Σ over common words of
        |a| + |b| − |a − b| (= 2·min(a, b) for positive weights), times ½."""
        s = 0.0
        for k, a in v1.items():
            b = v2.get(k)
            if b is not None:
                s += abs(a) + abs(b) - abs(a - b)
        return 0.5 * s

    def dense_vector(self, vec: dict) -> np.ndarray:
        out = np.zeros(self.num_words, np.float32)
        for k, v in vec.items():
            out[k] = v
        return out

    # -- persistence --------------------------------------------------------

    def save(self, path: str):
        np.savez_compressed(
            path,
            depth=self.depth,
            k=self.k,
            weights=self.weights.cpu().numpy(),
            **{f"level{l}": self.levels[l].cpu().numpy() for l in range(self.depth)},
            **{f"valid{l}": self.valid[l].cpu().numpy() for l in range(self.depth)},
        )

    @classmethod
    def load(cls, path: str, device="cpu") -> "Vocabulary":
        z = np.load(path)
        depth = int(z["depth"])
        levels = [z[f"level{l}"] for l in range(depth)]
        valid = [z[f"valid{l}"] for l in range(depth)] if "valid0" in z else None
        return cls(levels, z["weights"], valid, device=device)


# ---------------------------------------------------------------------------
# training: hierarchical k-means (numpy, as in the JAX package)
# ---------------------------------------------------------------------------


def _kmeans(desc: np.ndarray, k: int, iters: int, rng: np.random.RandomState):
    """k-means++ seeding + Lloyd; returns (centroids (k, D), assign (N,),
    valid (k,))."""
    n = len(desc)
    if n == 0:
        return np.zeros((k, desc.shape[1] if desc.ndim == 2 else 256), np.float32), \
            np.zeros(0, np.int32), np.zeros(k, bool)
    # k-means++ seeding
    cents = [desc[rng.randint(n)]]
    d2 = np.full(n, np.inf)
    for _ in range(1, min(k, n)):
        d2 = np.minimum(d2, ((desc - cents[-1]) ** 2).sum(axis=1))
        total = float(d2.sum())
        if total <= 1e-20 or not np.isfinite(total):
            cents.append(desc[rng.randint(n)])
            continue
        probs = np.clip(d2 / total, 0, None)
        probs = probs / probs.sum()
        cents.append(desc[rng.choice(n, p=probs)])
    c = np.stack(cents)
    valid = np.zeros(k, bool)
    valid[: len(c)] = True
    if len(c) < k:
        c = np.concatenate([c, np.zeros((k - len(c), desc.shape[1]), desc.dtype)])

    for _ in range(iters):
        d2 = ((desc[:, None, :] - c[None]) ** 2).sum(axis=-1)
        d2[:, ~valid] = np.inf
        assign = d2.argmin(axis=1)
        for j in range(k):
            sel = assign == j
            if valid[j] and sel.any():
                c[j] = desc[sel].mean(axis=0)
    d2 = ((desc[:, None, :] - c[None]) ** 2).sum(axis=-1)
    d2[:, ~valid] = np.inf
    return c.astype(np.float32), d2.argmin(axis=1).astype(np.int32), valid


def auto_depth(n_desc: int, k: int = 10, target_leaf: float = 20.0) -> int:
    """Tree depth so a leaf holds ~``target_leaf`` training descriptors:
    round(log_k(n / target_leaf)), clamped to [2, 5]."""
    n = max(int(n_desc), 1)
    return int(np.clip(round(np.log(n / target_leaf) / np.log(k)), 2, 5))


def train_vocabulary(descriptors: np.ndarray, k: int = 10, depth: int = None,
                     kmeans_iters: int = 8, seed: int = 0, device="cpu") -> Vocabulary:
    """Hierarchical k-means training (the role of
    ``TemplatedVocabulary::create`` with TF-IDF/L1, map_refiner.cc:958-981).
    ``depth=None`` sizes the tree so a leaf holds ~20 training descriptors
    (see :func:`auto_depth`). ``device``: where the vocabulary transforms."""
    rng = np.random.RandomState(seed)
    desc = np.asarray(descriptors, np.float32)
    d = desc.shape[1]
    if depth is None:
        depth = auto_depth(len(desc), k)

    levels = []
    valids = []
    assignments = np.zeros(len(desc), np.int64)  # node index at current level
    for l in range(depth):
        n_nodes = k ** l
        cents = np.zeros((n_nodes, k, d), np.float32)
        valid = np.zeros((n_nodes, k), bool)
        new_assign = np.zeros_like(assignments)
        for node in range(n_nodes):
            sel = assignments == node
            if not sel.any():
                continue
            c, a, v = _kmeans(desc[sel], k, kmeans_iters, rng)
            cents[node] = c
            valid[node] = v
            new_assign[sel] = node * k + a
        levels.append(cents)
        valids.append(valid)
        assignments = new_assign

    # TF-IDF weights: every training feature is one document unit,
    # idf_i = log(N / n_i); words never hit in training weigh 0
    n_words = k ** depth
    counts = np.bincount(assignments, minlength=n_words)
    weights = np.zeros(n_words, np.float32)
    nz = counts > 0
    weights[nz] = np.log(max(len(desc), 1) / counts[nz])
    return Vocabulary(levels, weights, valids, device=device)
