"""Speaker clustering: agglomerative pre-clustering, kMeans, VBx (VB-HMM)
(the port's copy of whisperkit_tpu/speaker/clustering.py).

Reference: Sources/SpeakerKit/Pyannote/ —
`SpeakerClustering.swift` (Clusterer protocol + VBxClusteringConfig,
:6-71), `VBxClustering.swift` (:45-248), `ClusteringAlgorithms.swift`
(fastLinkage :22-528, kMeans w/ SplitMix64 :134-299, VB-HMM :530-820),
`MathOps.swift` (cosine distances :14-170).

Clustering is host-side control logic over at most a few thousand
embeddings, not device work (SURVEY.md §2.3). The agglomerative step rides
scipy (`linkage`/`fcluster`); kMeans and VBx are implemented here, with the
same knob set the reference exposes (threshold .6, Fa .07, Fb .8, maxIter
20, loop-probability smoothing 7.0).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


# -- math ops (reference: MathOps.swift) ------------------------------------


def cosine_distance_matrix(a: np.ndarray, b: Optional[np.ndarray] = None) -> np.ndarray:
    b = a if b is None else b
    an = a / (np.linalg.norm(a, axis=1, keepdims=True) + 1e-10)
    bn = b / (np.linalg.norm(b, axis=1, keepdims=True) + 1e-10)
    return 1.0 - an @ bn.T


# -- seeded RNG (reference: SplitMix64, ClusteringAlgorithms.swift:134) -----


class SplitMix64:
    def __init__(self, seed: int):
        self.state = np.uint64(seed)

    def next(self) -> int:
        with np.errstate(over="ignore"):
            self.state = np.uint64(self.state + np.uint64(0x9E3779B97F4A7C15))
            z = self.state
            z = np.uint64((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9))
            z = np.uint64((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB))
            return int(z ^ (z >> np.uint64(31)))

    def uniform(self) -> float:
        return self.next() / 2**64

    def choice(self, n: int) -> int:
        return self.next() % n


# -- configs (reference: VBxClusteringConfig, SpeakerClustering.swift:6-42) --


@dataclasses.dataclass
class VBxClusteringConfig:
    cluster_distance_threshold: float = 0.6
    fa: float = 0.07
    fb: float = 0.8
    max_iterations: int = 20
    loop_probability_smoothing: float = 7.0
    min_cluster_size: int = 1
    min_active_ratio: float = 0.1


# -- agglomerative pre-clustering -------------------------------------------


def fast_linkage_cluster(
    embeddings: np.ndarray, threshold: float, min_cluster_size: int = 1
) -> np.ndarray:
    """Agglomerative (average-linkage on cosine distance) + flat threshold
    cut. Reference: fastLinkage + assignFlatClusters
    (ClusteringAlgorithms.swift:22-528, VBxClustering.swift:130)."""
    n = len(embeddings)
    if n == 0:
        return np.zeros(0, np.int32)
    if n == 1:
        return np.zeros(1, np.int32)
    from scipy.cluster.hierarchy import fcluster, linkage
    from scipy.spatial.distance import squareform

    dist = np.maximum(cosine_distance_matrix(embeddings), 0.0)
    np.fill_diagonal(dist, 0.0)
    condensed = squareform(dist, checks=False)
    z = linkage(condensed, method="average")
    labels = fcluster(z, t=threshold, criterion="distance") - 1

    # merge clusters smaller than min_cluster_size into nearest big cluster
    labels = labels.astype(np.int32)
    if min_cluster_size > 1:
        uniq, counts = np.unique(labels, return_counts=True)
        big = uniq[counts >= min_cluster_size]
        if len(big) > 0:
            centroids = np.stack([embeddings[labels == u].mean(0) for u in big])
            for u, c in zip(uniq, counts):
                if c < min_cluster_size:
                    members = labels == u
                    d = cosine_distance_matrix(embeddings[members], centroids)
                    labels[members] = big[np.argmin(d, axis=1)]
    # re-index labels densely
    _, dense = np.unique(labels, return_inverse=True)
    return dense.astype(np.int32)


# -- kMeans (reference: ClusteringAlgorithms.swift:134-299) ------------------


def kmeans(
    embeddings: np.ndarray, k: int, seed: int = 0, max_iterations: int = 50
) -> np.ndarray:
    n = len(embeddings)
    if n == 0:
        return np.zeros(0, np.int32)
    k = min(k, n)
    rng = SplitMix64(seed)
    # k-means++ seeding (squared-distance weighting) with the deterministic RNG
    centers = [embeddings[rng.choice(n)]]
    for _ in range(1, k):
        d = np.min(cosine_distance_matrix(embeddings, np.stack(centers)), axis=1)
        d2 = np.maximum(d, 0.0) ** 2
        probs = d2 / (d2.sum() + 1e-12)
        r = rng.uniform()
        centers.append(
            embeddings[min(int(np.searchsorted(np.cumsum(probs), r)), n - 1)]
        )
    centroids = np.stack(centers)

    labels = np.zeros(n, np.int32)
    for _ in range(max_iterations):
        d = cosine_distance_matrix(embeddings, centroids)
        new_labels = np.argmin(d, axis=1).astype(np.int32)
        if (new_labels == labels).all():
            labels = new_labels
            break
        labels = new_labels
        for j in range(k):
            members = embeddings[labels == j]
            if len(members):
                centroids[j] = members.mean(0)
            else:
                # empty cluster: reseed on the point farthest from its
                # current centroid (classic Lloyd empty-cluster repair)
                worst = int(np.argmax(d[np.arange(n), labels]))
                centroids[j] = embeddings[worst]
                labels[worst] = j
    return labels


# -- VBx (VB-HMM) refinement (reference: ClusteringAlgorithms.swift:530-820) -


def vbx_refine(
    embeddings: np.ndarray,  # [N, D] (L2-normalized)
    init_labels: np.ndarray,  # [N] from agglomerative pre-clustering
    config: VBxClusteringConfig = VBxClusteringConfig(),
) -> np.ndarray:
    """VB-HMM refinement of an initial clustering.

    Functional port of the VBx algorithm (Landini et al.; the reference's
    VariationalBayesHiddenMarkovModel.vbx): Gaussian speaker models with a
    MAP prior (Fa/Fb), HMM speaker transitions with a loop probability, and
    forward-backward responsibilities; empty speakers are dropped.
    """
    n, d = embeddings.shape
    if n == 0:
        return init_labels
    s = int(init_labels.max()) + 1
    if s <= 1:
        return init_labels
    fa, fb = config.fa, config.fb
    loop_p = 1.0 - 1.0 / (1.0 + config.loop_probability_smoothing)

    gamma = np.zeros((n, s))
    gamma[np.arange(n), init_labels] = 1.0

    x = embeddings
    # within-class variance from the initial clustering sets the emission
    # scale (the reference's PLDA model plays this role; unit-norm
    # embeddings need it or the HMM loop prior swamps the evidence)
    resid = x - np.stack([x[init_labels == c].mean(0) for c in range(s)])[init_labels]
    sigma2 = max(float(resid.var()), 1e-4)

    prev_elbo = -np.inf
    for _ in range(config.max_iterations):
        # M-step: MAP speaker means
        counts = gamma.sum(0)  # [S]
        sums = gamma.T @ x  # [S, D]
        mu = (fa * sums) / (fb + fa * counts[:, None] + 1e-12)

        # E-step: emission log-likelihoods (shared isotropic covariance,
        # acoustic-scaled by Fa)
        ll = (fa / sigma2) * (x @ mu.T - 0.5 * (mu**2).sum(1)[None, :])  # [N, S]

        # forward-backward with loop-probability transitions
        trans = np.full((s, s), (1.0 - loop_p) / max(s - 1, 1))
        np.fill_diagonal(trans, loop_p)
        log_trans = np.log(trans + 1e-30)

        log_alpha = np.zeros((n, s))
        log_alpha[0] = ll[0] - np.log(s)
        for t in range(1, n):
            m = log_alpha[t - 1][:, None] + log_trans
            log_alpha[t] = ll[t] + _logsumexp_cols(m)
        log_beta = np.zeros((n, s))
        for t in range(n - 2, -1, -1):
            m = log_trans + (ll[t + 1] + log_beta[t + 1])[None, :]
            log_beta[t] = _logsumexp_rows(m)

        log_gamma = log_alpha + log_beta
        log_gamma -= log_gamma.max(1, keepdims=True)
        gamma = np.exp(log_gamma)
        gamma /= gamma.sum(1, keepdims=True) + 1e-30

        elbo = _logsumexp_rows(log_alpha[-1][None, :])[0]
        if abs(elbo - prev_elbo) < 1e-4 * max(abs(prev_elbo), 1.0):
            break
        prev_elbo = elbo

    labels = gamma.argmax(1)
    # drop empty speakers, re-index densely
    _, dense = np.unique(labels, return_inverse=True)
    return dense.astype(np.int32)


def _logsumexp_rows(m: np.ndarray) -> np.ndarray:
    mx = m.max(axis=1, keepdims=True)
    return (mx + np.log(np.exp(m - mx).sum(axis=1, keepdims=True)))[:, 0]


def _logsumexp_cols(m: np.ndarray) -> np.ndarray:
    mx = m.max(axis=0, keepdims=True)
    return (mx + np.log(np.exp(m - mx).sum(axis=0, keepdims=True)))[0]


# -- Clusterer (reference: Clusterer protocol + VBxClustering actor) --------


class VBxClusterer:
    """Accumulate embeddings, then cluster: AHC pre-clustering → VBx
    refinement → cosine re-assignment; kMeans fallback when the speaker
    count is fixed. Reference: VBxClustering.swift:45-248."""

    def __init__(
        self,
        config: Optional[VBxClusteringConfig] = None,
        plda: Optional[np.ndarray] = None,  # [D, D'] projection
    ):
        self.config = config or VBxClusteringConfig()
        # optional PLDA-style projection applied before clustering
        # (reference: SpeakerEmbedderModel's optional PLDA model,
        # SpeakerEmbedderModel.swift + PyannoteModelManager PLDA ModelInfo)
        self.plda = plda
        self._embeddings: list[np.ndarray] = []
        self._active_ratios: list[float] = []

    def add(self, embedding: np.ndarray, active_ratio: float = 1.0) -> None:
        emb = np.asarray(embedding, np.float32)
        if self.plda is not None:
            emb = emb @ self.plda
            emb = emb / (np.linalg.norm(emb) + 1e-10)
        self._embeddings.append(emb)
        self._active_ratios.append(active_ratio)

    def reset(self) -> None:
        self._embeddings.clear()
        self._active_ratios.clear()

    def cluster(self, num_speakers: Optional[int] = None) -> np.ndarray:
        """Labels for every added embedding (low-activity ones assigned to
        their nearest centroid after clustering the confident ones)."""
        if not self._embeddings:
            return np.zeros(0, np.int32)
        embeddings = np.stack(self._embeddings)
        ratios = np.asarray(self._active_ratios)
        confident = ratios >= self.config.min_active_ratio
        if not confident.any():
            confident = np.ones(len(embeddings), bool)
        core = embeddings[confident]

        if num_speakers is not None:
            core_labels = kmeans(core, num_speakers)
        else:
            init = fast_linkage_cluster(
                core,
                self.config.cluster_distance_threshold,
                self.config.min_cluster_size,
            )
            core_labels = vbx_refine(core, init, self.config)

        # densify labels first: empty intermediate label ids would yield
        # NaN centroids that argmin then selects for every re-assignment
        uniq, core_labels = np.unique(core_labels, return_inverse=True)
        core_labels = core_labels.astype(np.int32)
        n_clusters = len(uniq)
        centroids = np.stack(
            [core[core_labels == j].mean(0) for j in range(n_clusters)]
        )
        # cosine re-assignment of every embedding to the final centroids
        labels = np.argmin(
            cosine_distance_matrix(embeddings, centroids), axis=1
        ).astype(np.int32)
        labels[confident] = core_labels
        return labels
