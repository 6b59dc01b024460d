"""Geometry Score (GS) — topology comparison of two feature sets: a copy of
tango_tpu/eval/gs.py, which is numpy only.

Native numpy implementation of the reference's gs package
(audioldm_eval/metrics/gs/geom_score.py:1-68, utils.py:1-148
— Khrulkov & Oseledets, "Geometry Score", ICML 2018). The reference delegates
the witness complex + H1 persistence to gudhi (a C++ dependency, and DEAD
CODE there: EvaluationHelper never calls it); here both are implemented
directly:

  * witness complex: the nu=1 LAZY witness complex (de Silva & Carlsson,
    "Topological estimation using witness complexes"): a simplex sigma over
    landmarks enters the filtration at
        alpha(sigma) = min over witnesses w of
                       [ max_{p in sigma} d(w, p) - d_min(w) ]
    where d_min(w) is the distance from w to its nearest landmark. Built up
    to dimension 2 (triangles), truncated at alpha_max = gamma * max d(W, L)
    — the same truncation the reference passes to gudhi
    (utils.py:witness: max_alpha_square = max_dist * gamma). gudhi's relaxed
    witness filtration differs in low-order details; the RLT statistic
    (time-weighted histogram of beta_1) is the published quantity and is
    reproduced per formulas (2)-(3) of the paper, exactly as utils.relative
    does.
  * persistence: standard Z/2 boundary-matrix reduction. H0 deaths via
    union-find over filtration-sorted edges; surviving (positive) edges
    create H1 classes; triangle columns are reduced against them to produce
    the (birth, death) intervals of H1.

API mirrors the reference: rlt / rlts / geom_score.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


# ------------------------------------------------------------ witness complex

def _pairwise_dist(W: np.ndarray, L: np.ndarray) -> np.ndarray:
    """(w, l) Euclidean distances (scipy.spatial.distance.cdist equivalent)."""
    w2 = np.sum(W * W, axis=1)[:, None]
    l2 = np.sum(L * L, axis=1)[None, :]
    d2 = np.maximum(w2 + l2 - 2.0 * (W @ L.T), 0.0)
    return np.sqrt(d2)


def _witness_filtrations(D: np.ndarray, alpha_max: float):
    """Edge and triangle filtration values of the lazy witness complex.

    D: (n_witness, n_landmark) distances. Returns (edges, triangles) where
    edges is a list of (alpha, i, j) with alpha <= alpha_max and triangles a
    list of (alpha, i, j, k); triangle alphas are clamped to be >= their
    edges' (filtration monotonicity).
    """
    n_l = D.shape[1]
    m = np.min(D, axis=1)  # d_min(w)

    # edges: alpha(i, j) = min_w max(D[w,i], D[w,j]) - m(w); pm is reused by
    # the triangle loop below (the (W, L, L) broadcast dominates cost/memory)
    pm = np.maximum(D[:, :, None], D[:, None, :])
    edge_alpha = np.min(pm - m[:, None, None], axis=0)  # (L, L)
    np.fill_diagonal(edge_alpha, np.inf)
    edge_alpha = np.maximum(edge_alpha, 0.0)

    edges = []
    ei, ej = np.where(np.triu(edge_alpha <= alpha_max, k=1))
    for i, j in zip(ei.tolist(), ej.tolist()):
        edges.append((float(edge_alpha[i, j]), i, j))

    # triangles: alpha(i, j, k) = min_w [max3 - m(w)], computed per third
    # vertex to keep memory at (W, L, L)
    triangles = []
    for k in range(2, n_l):
        # triangle (i, j, k), i < j < k: max3 = max(pairmax(i, j), D[:, k])
        tri = np.min(
            np.maximum(pm[:, :k, :k], D[:, k][:, None, None]) - m[:, None, None],
            axis=0,
        )
        tri = np.maximum(tri, 0.0)
        ti, tj = np.where(np.triu(tri <= alpha_max, k=1))
        for i, j in zip(ti.tolist(), tj.tolist()):
            # monotone filtration: a triangle cannot appear before its edges
            a = max(
                float(tri[i, j]),
                float(edge_alpha[i, j]),
                float(edge_alpha[i, k]),
                float(edge_alpha[j, k]),
            )
            if a <= alpha_max:
                triangles.append((a, i, j, k))
    return edges, triangles


# --------------------------------------------------------------- persistence

class _UnionFind:
    def __init__(self, n):
        self.parent = list(range(n))

    def find(self, x):
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a, b) -> bool:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return False
        self.parent[ra] = rb
        return True


def _h1_intervals(edges, triangles, n_vertices: int):
    """H1 persistence intervals over Z/2.

    Edges/triangles sorted by filtration; union-find detects the POSITIVE
    edges (cycle creators). Triangle boundary columns are reduced against
    the positive-edge basis: a pivot pairs (edge_birth -> triangle_death);
    unpaired positive edges persist to infinity.
    """
    edges = sorted(edges)
    triangles = sorted(triangles)

    uf = _UnionFind(n_vertices)
    positive = []  # (alpha, i, j) creating a 1-cycle
    edge_index = {}
    for alpha, i, j in edges:
        if not uf.union(i, j):
            edge_index[(i, j)] = len(positive)
            positive.append(alpha)
        else:
            edge_index[(i, j)] = None  # negative edge: kills H0, never a pivot

    # negative-edge spanning structure: to express a triangle boundary in the
    # positive-edge basis we walk cycles — instead use the standard trick:
    # reduce full boundary columns over ALL edges, but pivots on negative
    # edges cancel against the (implicit) H0 pairing. The textbook reduction
    # over edge columns directly is simplest and exact:
    #   column(t) = {its 3 edges}; low = max edge by (alpha, index) order;
    #   add previously-reduced columns with the same low until empty or new.
    order = {}
    for idx, (alpha, i, j) in enumerate(edges):
        order[(i, j)] = idx

    births = {}
    low_to_col = {}
    intervals = []
    for alpha, i, j, k in triangles:
        col = {order[(i, j)], order[(i, k)], order[(j, k)]}  # i < j < k
        while col:
            low = max(col)
            if low in low_to_col:
                col ^= low_to_col[low]
            else:
                break
        if col:
            low = max(col)
            low_to_col[low] = col
            e_alpha, ei_, ej_ = edges[low]
            if edge_index.get((ei_, ej_)) is not None:
                # positive edge killed: interval [edge birth, triangle death]
                intervals.append((e_alpha, alpha))
                births[(ei_, ej_)] = True
        # an empty column means the triangle creates an H2 class — ignored

    for (i, j), idx in edge_index.items():
        if idx is not None and not births.get((i, j)):
            intervals.append((positive[idx], np.inf))
    return intervals


# ----------------------------------------------------------------- public API

def relative(I_1, alpha_max: float, i_max: int = 100) -> np.ndarray:
    """RLT from intervals — formulas (2)-(3) (reference utils.relative)."""
    persistence_intervals = []
    for interval in I_1:
        end = alpha_max if np.isinf(interval[1]) else interval[1]
        persistence_intervals.append([interval[0], end])

    if not persistence_intervals:
        rlt = np.zeros(i_max)
        rlt[0] = 1.0
        return rlt

    ext = np.array(persistence_intervals + [[0, alpha_max]])
    arr = np.array(persistence_intervals)
    switch_points = np.sort(np.unique(ext.flatten()))
    rlt = np.zeros(i_max)
    for i in range(switch_points.shape[0] - 1):
        midpoint = (switch_points[i] + switch_points[i + 1]) / 2
        s = int(np.sum((midpoint >= arr[:, 0]) & (midpoint < arr[:, 1])))
        if s < i_max:
            rlt[s] += switch_points[i + 1] - switch_points[i]
    return rlt / alpha_max


def witness(X: np.ndarray, gamma: float = 1.0 / 128, L_0: int = 64,
            rng: Optional[np.random.RandomState] = None):
    """Persistence intervals of the witness complex on random landmarks
    (reference utils.witness; gudhi replaced by the native reduction)."""
    rng = rng or np.random
    idx = rng.choice(X.shape[0], L_0)
    L = X[idx]
    D = _pairwise_dist(X, L)
    alpha_max = float(np.max(D)) * gamma
    edges, triangles = _witness_filtrations(D, alpha_max)
    return _h1_intervals(edges, triangles, L_0), alpha_max


def rlt(X: np.ndarray, L_0: int = 64, gamma: Optional[float] = None,
        i_max: int = 100, rng=None) -> np.ndarray:
    """Algorithm 1, one landmark sample (reference geom_score.rlt)."""
    if not isinstance(X, np.ndarray):
        raise ValueError("X should be a numpy array")
    if len(X.shape) != 2:
        raise ValueError(f"X should be 2d array, got shape {X.shape}")
    N = X.shape[0]
    if gamma is None:
        gamma = 1.0 / 128 * N / 5000
    I_1, alpha_max = witness(X, gamma=gamma, L_0=L_0, rng=rng)
    return relative(I_1, alpha_max, i_max=i_max)


def rlts(X: np.ndarray, L_0: int = 64, gamma: Optional[float] = None,
         i_max: int = 100, n: int = 1000, seed: Optional[int] = None) -> np.ndarray:
    """Algorithm 1, n landmark samples (reference geom_score.rlts)."""
    rng = np.random.RandomState(seed) if seed is not None else np.random
    out = np.zeros((n, i_max))
    for i in range(n):
        out[i, :] = rlt(X, L_0, gamma, i_max, rng=rng)
    return out


def geom_score(rlts1: np.ndarray, rlts2: np.ndarray) -> float:
    """Algorithm 2 (reference geom_score.geom_score)."""
    mrlt1 = np.mean(rlts1, axis=0)
    mrlt2 = np.mean(rlts2, axis=0)
    return float(np.sum((mrlt1 - mrlt2) ** 2))
