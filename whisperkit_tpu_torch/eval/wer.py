"""WER computation with word-level alignment (the port's copy of
whisperkit_tpu/eval/wer.py).

Reference: Tests/WhisperKitTests/Evaluate/ —
`DistanceCalculation.swift:8-196` (Needleman-Wunsch / Hirschberg /
Levenshtein alignment) and `WERUtils.swift:44-125`
(`processWords`/`evaluate`). Small inputs use a full DP matrix with
traceback; above `_MATRIX_CELL_BUDGET` cells the alignment switches to
Hirschberg divide-and-conquer (linear memory, like the reference's
`DistanceCalculation.swift:8-60` hirschberg), so hour-scale transcript
pairs (20k+ words each) align in O(min(n, m)) memory instead of the
O(N·M) int32 matrix (~1.6 GB for a 2-hour pair).

Both paths are vectorized: the sequential along-row insertion dependence
(`row[j] = min(cand[j], row[j-1]+1)`) collapses to a running minimum —
`row[j] = min_{k<=j}(cand[k] - k) + j` — computed with
`np.minimum.accumulate`, so there is no per-cell Python loop anywhere.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from whisperkit_tpu_torch.eval.normalize import EnglishTextNormalizer

# Full-matrix alignments above this many DP cells switch to Hirschberg.
# 16M cells ≈ 64 MB int32 — comfortably small, and below it the matrix
# path's exact traceback (and its tie-breaking) is preserved bit-for-bit.
_MATRIX_CELL_BUDGET = 16_000_000


@dataclasses.dataclass
class AlignmentChunk:
    """One aligned op span (jiwer-style, like the reference's ops list)."""

    kind: str  # "equal" | "replace" | "delete" | "insert"
    ref_start: int
    ref_end: int
    hyp_start: int
    hyp_end: int


@dataclasses.dataclass
class WERResult:
    wer: float
    hits: int
    substitutions: int
    deletions: int
    insertions: int
    n_ref_words: int
    chunks: list[AlignmentChunk]

    @property
    def accuracy(self) -> float:
        return 1.0 - self.wer


def _encode_words(
    ref: Sequence[str], hyp: Sequence[str]
) -> tuple[np.ndarray, np.ndarray]:
    """Map words to int codes so DP rows compare int arrays, not objects."""
    both = list(ref) + list(hyp)
    _, codes = np.unique(np.asarray(both, dtype=object), return_inverse=True)
    codes = codes.astype(np.int32)
    return codes[: len(ref)], codes[len(ref) :]


def _row_update(prev: np.ndarray, row0: int, sub_cost: np.ndarray) -> np.ndarray:
    """One vectorized DP row (length m+1) from the previous row.

    cand[j] = min(prev[j] + 1, prev[j-1] + sub[j]) for j >= 1; the
    insertion chain row[j] = min(cand[j], row[j-1] + 1) is a running
    minimum of (cand[k] - k): row[j] = min_{k<=j}(cand[k] - k) + j.
    """
    m = sub_cost.shape[0]
    cand = np.empty(m + 1, np.int64)
    cand[0] = row0
    np.minimum(prev[1:] + 1, prev[:-1] + sub_cost, out=cand[1:])
    cand -= np.arange(m + 1)
    np.minimum.accumulate(cand, out=cand)
    cand += np.arange(m + 1)
    return cand


def _edit_matrix(ref_ids: np.ndarray, hyp_ids: np.ndarray) -> np.ndarray:
    """Full DP cost matrix (substitution=1), one vectorized pass per row."""
    n, m = len(ref_ids), len(hyp_ids)
    d = np.zeros((n + 1, m + 1), np.int64)
    d[0, :] = np.arange(m + 1)
    d[:, 0] = np.arange(n + 1)
    for i in range(1, n + 1):
        sub_cost = (hyp_ids != ref_ids[i - 1]).astype(np.int64)
        d[i] = _row_update(d[i - 1], i, sub_cost)
    return d


def _last_row(ref_ids: np.ndarray, hyp_ids: np.ndarray) -> np.ndarray:
    """Last DP row only — O(m) memory (Hirschberg forward/backward pass)."""
    m = len(hyp_ids)
    prev = np.arange(m + 1, dtype=np.int64)
    for i in range(1, len(ref_ids) + 1):
        sub_cost = (hyp_ids != ref_ids[i - 1]).astype(np.int64)
        prev = _row_update(prev, i, sub_cost)
    return prev


def _traceback_ops(
    d: np.ndarray, ref_ids: np.ndarray, hyp_ids: np.ndarray
) -> list[str]:
    i, j = len(ref_ids), len(hyp_ids)
    ops: list[str] = []
    while i > 0 or j > 0:
        if (
            i > 0
            and j > 0
            and ref_ids[i - 1] == hyp_ids[j - 1]
            and d[i, j] == d[i - 1, j - 1]
        ):
            ops.append("equal")
            i, j = i - 1, j - 1
        elif i > 0 and j > 0 and d[i, j] == d[i - 1, j - 1] + 1:
            ops.append("replace")
            i, j = i - 1, j - 1
        elif i > 0 and d[i, j] == d[i - 1, j] + 1:
            ops.append("delete")
            i -= 1
        else:
            ops.append("insert")
            j -= 1
    ops.reverse()
    return ops


def _align_ids(ref_ids: np.ndarray, hyp_ids: np.ndarray) -> list[str]:
    """Optimal edit ops; Hirschberg recursion above the cell budget."""
    n, m = len(ref_ids), len(hyp_ids)
    if n == 0:
        return ["insert"] * m
    if m == 0:
        return ["delete"] * n
    if n == 1 or m == 1 or (n + 1) * (m + 1) <= _MATRIX_CELL_BUDGET:
        return _traceback_ops(_edit_matrix(ref_ids, hyp_ids), ref_ids, hyp_ids)
    mid = n // 2
    fwd = _last_row(ref_ids[:mid], hyp_ids)
    bwd = _last_row(ref_ids[mid:][::-1], hyp_ids[::-1])[::-1]
    split = int(np.argmin(fwd + bwd))
    return _align_ids(ref_ids[:mid], hyp_ids[:split]) + _align_ids(
        ref_ids[mid:], hyp_ids[split:]
    )


def align_words(ref: Sequence[str], hyp: Sequence[str]) -> list[AlignmentChunk]:
    ref_ids, hyp_ids = _encode_words(ref, hyp)
    ops = _align_ids(ref_ids, hyp_ids)

    chunks: list[AlignmentChunk] = []
    ri = hi = 0
    for op in ops:
        dr = 1 if op in ("equal", "replace", "delete") else 0
        dh = 1 if op in ("equal", "replace", "insert") else 0
        if chunks and chunks[-1].kind == op:
            chunks[-1].ref_end += dr
            chunks[-1].hyp_end += dh
        else:
            chunks.append(AlignmentChunk(op, ri, ri + dr, hi, hi + dh))
        ri += dr
        hi += dh
    return chunks


def evaluate(
    reference: str,
    hypothesis: str,
    normalizer=None,
) -> WERResult:
    """Normalized WER (reference: WERUtils.swift:110-125 `evaluate`)."""
    normalizer = normalizer or EnglishTextNormalizer()
    ref_words = normalizer(reference).split()
    hyp_words = normalizer(hypothesis).split()
    if not ref_words:
        wer = 0.0 if not hyp_words else 1.0
        return WERResult(wer, 0, 0, 0, len(hyp_words), 0, [])
    chunks = align_words(ref_words, hyp_words)
    hits = subs = dels = ins = 0
    for c in chunks:
        n = max(c.ref_end - c.ref_start, c.hyp_end - c.hyp_start)
        if c.kind == "equal":
            hits += n
        elif c.kind == "replace":
            subs += n
        elif c.kind == "delete":
            dels += n
        else:
            ins += n
    wer = (subs + dels + ins) / len(ref_words)
    return WERResult(
        wer=wer,
        hits=hits,
        substitutions=subs,
        deletions=dels,
        insertions=ins,
        n_ref_words=len(ref_words),
        chunks=chunks,
    )


def wer(reference: str, hypothesis: str, normalizer=None) -> float:
    return evaluate(reference, hypothesis, normalizer).wer
