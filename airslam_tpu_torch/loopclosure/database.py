"""BoW database: per-frame vectors, inverted file, shared-word queries and
batched L1 scoring.

Port of ``airslam_tpu/loopclosure/database.py`` (which replaces
``src/bow/database.cc``). The inverted file is word_id → {frame_id:
[feature indices]}; shared-word counting (database.cc:111-123) runs over a
CSR mirror of it in the native kernel (``utils/native.invfile_query``), plus
a Python walk of the postings added since the mirror was last built. All of
it is host bookkeeping in numpy, as in the JAX package; only the
vocabulary's transform runs on its device.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from airslam_tpu_torch.loopclosure.vocabulary import Vocabulary
from airslam_tpu_torch.utils import native


class Database:
    def __init__(self, voc: Vocabulary):
        self.voc = voc
        self.inverted_file: Dict[int, Dict[int, List[int]]] = {}
        self.frame_bow: Dict[int, dict] = {}  # frame_id -> {word: weight}
        self.frame_words: Dict[int, np.ndarray] = {}  # frame_id -> per-feature word ids
        # CSR mirror of the inverted file, rebuilt when the database has grown
        # 25 % past the last build; postings added since then live in _delta
        self._csr = None  # (offsets int64 (W+1,), frames int32, slot -> frame id)
        self._csr_n = 0
        self._delta: Dict[int, List[int]] = {}

    # -- FrameToBow (database.cc:58-91) -------------------------------------

    def frame_to_bow(self, desc: np.ndarray, mask: Optional[np.ndarray] = None):
        """Returns (bow_vector {word: weight}, word_of_features (N,),
        word_features {word: [indices]})."""
        vec, wids = self.voc.bow_vector(desc, mask)
        word_features: Dict[int, List[int]] = {}
        for i, wid in enumerate(wids):
            if wid >= 0 and (mask is None or mask[i]):
                word_features.setdefault(int(wid), []).append(i)
        return vec, wids, word_features

    # -- AddFrame ------------------------------------------------------------

    def add_frame(self, frame_id: int, desc: np.ndarray, mask=None):
        vec, wids, word_features = self.frame_to_bow(desc, mask)
        self.add_frame_bow(frame_id, vec, wids, word_features)
        return vec, wids

    def add_frame_bow(self, frame_id: int, vec: dict, wids, word_features: dict):
        self.frame_bow[frame_id] = vec
        self.frame_words[frame_id] = np.asarray(wids)
        for wid, idxs in word_features.items():
            self.inverted_file.setdefault(wid, {})[frame_id] = list(idxs)
            self._delta.setdefault(wid, []).append(frame_id)

    # -- Query (database.cc:111-123) -----------------------------------------

    def _rebuild_csr(self):
        slots = sorted(self.frame_bow)
        slot_of = {fid: i for i, fid in enumerate(slots)}
        W = (max(self.inverted_file) + 1) if self.inverted_file else 1
        counts = np.zeros(W + 1, np.int64)
        for wid, frames in self.inverted_file.items():
            counts[wid + 1] = len(frames)
        offsets = np.cumsum(counts)
        frames_arr = np.zeros(int(offsets[-1]), np.int32)
        cur = offsets[:-1].copy()
        for wid, frames in self.inverted_file.items():
            for fid in frames:
                frames_arr[cur[wid]] = slot_of[fid]
                cur[wid] += 1
        self._csr = (offsets, frames_arr, slots)
        self._csr_n = len(slots)
        self._delta = {}

    def query(self, vec: dict) -> Dict[int, int]:
        """Shared-word counts per stored frame: the CSR scan in the native
        kernel plus a Python walk of the small post-build delta; the same
        counts as the reference's inverted-file walk."""
        if not self.frame_bow:
            return {}
        if self._csr is None or len(self.frame_bow) > self._csr_n * 1.25 + 8:
            self._rebuild_csr()
        offsets, frames_arr, slots = self._csr
        qwords = np.fromiter(vec.keys(), np.int32, len(vec))
        c = native.invfile_query(qwords, offsets, frames_arr, len(slots))
        counts: Dict[int, int] = {slots[i]: int(c[i]) for i in np.nonzero(c)[0]}
        for wid in vec:
            for fid in self._delta.get(wid, ()):
                counts[fid] = counts.get(fid, 0) + 1
        return counts

    def score(self, v1: dict, v2: dict) -> float:
        return Vocabulary.score_l1(v1, v2)

    def batched_scores(self, vec: dict, frame_ids: List[int]) -> np.ndarray:
        """L1 scores of a query against many frames as one dense reduction:
        ½ Σ (|a| + |b| − |a − b|) over the words."""
        if not frame_ids:
            return np.zeros(0, np.float32)
        q = self.voc.dense_vector(vec)
        m = np.stack([self.voc.dense_vector(self.frame_bow[f]) for f in frame_ids])
        s = 0.5 * (np.abs(q[None]) + np.abs(m) - np.abs(q[None] - m)).sum(axis=1)
        return s.astype(np.float32)

    # -- persistence ---------------------------------------------------------

    def state_dict(self) -> dict:
        return dict(
            inverted_file=self.inverted_file,
            frame_bow=self.frame_bow,
            frame_words={k: np.asarray(v) for k, v in self.frame_words.items()},
        )

    def load_state_dict(self, d: dict):
        self.inverted_file = d["inverted_file"]
        self.frame_bow = d["frame_bow"]
        self.frame_words = d["frame_words"]
        self._csr = None
        self._csr_n = 0
        self._delta = {}
