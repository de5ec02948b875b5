"""Lightweight numpy gradient boosting — the XGBoost stand-in for EcoPred.

The paper's EcoPred (Appx. C) uses two boosters:

* prefill: ``booster='gblinear'`` with MAE objective — :class:`GBLinear`,
  boosted ridge-linear base learners (prefill latency is near-linear in
  ``N_tok``, paper Fig. 10a).
* decode: ``booster='gbtree'`` with MAE objective — :class:`GBTree`,
  histogram gradient-boosted regression trees (decode latency is a tiled
  staircase over ``(N_req, N_kv)``, paper Fig. 10b — trees capture the
  cliffs).

Both support ``continue_fit`` (warm-start boosting on fresh residuals),
which is the mechanism behind EcoPred's online adaptation (§V-D): the
offline model keeps its trees and new rounds absorb the distribution shift.

Implementation notes: features are quantile-binned to uint8 (256 bins) once
per ``fit``; node split search is vectorized ``np.bincount`` histograms;
LAD (absolute-error) boosting uses variance-reduction splits on raw
residuals with **median** leaf values (Friedman's LAD tree), matching the
paper's ``reg:absoluteerror``.

Ensemble predictions are pure functions of the binned (uint8) feature
rows, so :meth:`GBTree.predict_binned` memoizes per-row on the binned
bytes — bit-exact by construction (a hit returns the very float the walk
produced) and invalidated whenever the ensemble mutates (``fit`` /
``continue_fit``).  EcoFreq queries the same ``(N_req, N_kv)`` state
across the whole frequency ladder every iteration, and the engine
re-predicts the chosen row for straggler-bias tracking, so steady-state
serving hits this cache almost every call.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

# ---------------------------------------------------------------------------
# GBLinear
# ---------------------------------------------------------------------------


class GBLinear:
    """Boosted L2-regularized linear model (XGBoost ``gblinear`` analogue)."""

    def __init__(
        self,
        n_rounds: int = 60,
        learning_rate: float = 0.5,
        l2: float = 1e-3,
        objective: str = "mae",
    ):
        self.n_rounds = n_rounds
        self.learning_rate = learning_rate
        self.l2 = l2
        self.objective = objective
        self.coef_: Optional[np.ndarray] = None
        self.intercept_: float = 0.0
        self._mu: Optional[np.ndarray] = None
        self._sd: Optional[np.ndarray] = None
        # bumped on every (re)fit so decision-level memos above the
        # predictor can detect model mutation without holding references
        self.version = 0

    def _z(self, X: np.ndarray) -> np.ndarray:
        return (X - self._mu) / self._sd

    def fit(self, X: np.ndarray, y: np.ndarray) -> "GBLinear":
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        self._mu = X.mean(axis=0)
        self._sd = np.maximum(X.std(axis=0), 1e-12)
        Z = self._z(X)
        n, d = Z.shape
        self.coef_ = np.zeros(d)
        self.intercept_ = float(np.median(y) if self.objective == "mae"
                                else y.mean())
        A = Z.T @ Z + self.l2 * np.eye(d)
        for _ in range(self.n_rounds):
            pred = Z @ self.coef_ + self.intercept_
            res = y - pred
            if self.objective == "mae":
                # LAD boosting: step toward the residual median + a ridge fit
                # of the residuals (scale-aware direction)
                self.intercept_ += self.learning_rate * float(np.median(res))
                res = y - (Z @ self.coef_ + self.intercept_)
            step = np.linalg.solve(A, Z.T @ res)
            self.coef_ += self.learning_rate * step
        self.version += 1
        return self

    def continue_fit(self, X: np.ndarray, y: np.ndarray,
                     n_rounds: Optional[int] = None) -> "GBLinear":
        """Online adaptation: extra boosting rounds on fresh data only."""
        assert self.coef_ is not None, "fit() first"
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        Z = self._z(X)
        d = Z.shape[1]
        A = Z.T @ Z + self.l2 * np.eye(d)
        for _ in range(n_rounds or max(10, self.n_rounds // 4)):
            pred = Z @ self.coef_ + self.intercept_
            res = y - pred
            if self.objective == "mae":
                self.intercept_ += self.learning_rate * float(np.median(res))
                res = y - (Z @ self.coef_ + self.intercept_)
            step = np.linalg.solve(A, Z.T @ res)
            self.coef_ += self.learning_rate * step
        self.version += 1
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        Z = self._z(np.asarray(X, np.float64))
        return Z @ self.coef_ + self.intercept_


# ---------------------------------------------------------------------------
# Histogram regression tree (LAD / L2)
# ---------------------------------------------------------------------------

_MAX_BINS = 256


@dataclass
class _Tree:
    feature: np.ndarray  # (nodes,) int32, -1 for leaf
    threshold: np.ndarray  # (nodes,) uint8 bin id: go left if bin <= thr
    left: np.ndarray  # (nodes,) int32
    right: np.ndarray  # (nodes,) int32
    value: np.ndarray  # (nodes,) float64 leaf values

    def predict_binned(self, B: np.ndarray) -> np.ndarray:
        """B: (n, d) uint8 binned features."""
        node = np.zeros(B.shape[0], np.int32)
        out = np.empty(B.shape[0], np.float64)
        active = np.arange(B.shape[0])
        for _ in range(64):  # depth bound
            if active.size == 0:
                break
            f = self.feature[node]
            leaf = f < 0
            if leaf.any():
                idx = active[leaf]
                out[idx] = self.value[node[leaf]]
                keep = ~leaf
                active, node = active[keep], node[keep]
                if active.size == 0:
                    break
            f = self.feature[node]
            go_left = B[active, f] <= self.threshold[node]
            node = np.where(go_left, self.left[node], self.right[node])
        return out


def _fit_tree(
    B: np.ndarray,  # (n, d) uint8
    res: np.ndarray,  # residuals to fit
    max_depth: int,
    min_leaf: int,
    objective: str,
    rng: np.random.Generator,
    colsample: float = 1.0,
    n_bins: int = _MAX_BINS,
) -> _Tree:
    n, d = B.shape
    feats: List[int] = []
    thrs: List[int] = []
    lefts: List[int] = []
    rights: List[int] = []
    vals: List[float] = []

    def leaf_value(idx: np.ndarray) -> float:
        r = res[idx]
        return float(np.median(r) if objective == "mae" else r.mean())

    def build(idx: np.ndarray, depth: int) -> int:
        node_id = len(feats)
        feats.append(-1)
        thrs.append(0)
        lefts.append(-1)
        rights.append(-1)
        vals.append(0.0)
        if depth >= max_depth or idx.size < 2 * min_leaf:
            vals[node_id] = leaf_value(idx)
            return node_id
        r = res[idx]
        tot_s, tot_n = r.sum(), idx.size
        best = (0.0, -1, -1)  # (gain, feature, thr)
        cols = range(d)
        if colsample < 1.0:
            k = max(1, int(round(colsample * d)))
            cols = rng.choice(d, size=k, replace=False)
        for f in cols:
            b = B[idx, f].astype(np.int64)
            cnt = np.bincount(b, minlength=n_bins).astype(np.float64)
            s = np.bincount(b, weights=r, minlength=n_bins)
            c_cnt = np.cumsum(cnt)[:-1]
            c_s = np.cumsum(s)[:-1]
            nl, nr = c_cnt, tot_n - c_cnt
            ok = (nl >= min_leaf) & (nr >= min_leaf)
            if not ok.any():
                continue
            gain = np.where(
                ok,
                c_s**2 / np.maximum(nl, 1)
                + (tot_s - c_s) ** 2 / np.maximum(nr, 1),
                -np.inf,
            )
            j = int(np.argmax(gain))
            g = gain[j] - tot_s**2 / tot_n
            if g > best[0] + 1e-12:
                best = (g, int(f), j)
        if best[1] < 0:
            vals[node_id] = leaf_value(idx)
            return node_id
        _, f, thr = best
        mask = B[idx, f] <= thr
        li = build(idx[mask], depth + 1)
        ri = build(idx[~mask], depth + 1)
        feats[node_id] = f
        thrs[node_id] = thr
        lefts[node_id] = li
        rights[node_id] = ri
        return node_id

    build(np.arange(n), 0)
    return _Tree(
        np.asarray(feats, np.int32),
        np.asarray(thrs, np.uint8),
        np.asarray(lefts, np.int32),
        np.asarray(rights, np.int32),
        np.asarray(vals, np.float64),
    )


# ---------------------------------------------------------------------------
# GBTree
# ---------------------------------------------------------------------------


class GBTree:
    """Histogram gradient-boosted regression trees (``gbtree`` analogue).

    Prediction packs the whole ensemble into padded node arrays and walks
    all trees level-synchronously — O(max_depth) numpy ops regardless of
    ensemble size, which keeps EcoFreq's per-iteration query sub-millisecond
    (the paper's <0.5 ms requirement, §V-C).
    """

    def __init__(
        self,
        n_estimators: int = 200,
        learning_rate: float = 0.1,
        max_depth: int = 6,
        min_leaf: int = 4,
        subsample: float = 0.8,
        colsample: float = 0.8,
        objective: str = "mae",
        early_stopping_rounds: int = 50,
        seed: int = 42,
    ):
        self.n_estimators = n_estimators
        self.learning_rate = learning_rate
        self.max_depth = max_depth
        self.min_leaf = min_leaf
        self.subsample = subsample
        self.colsample = colsample
        self.objective = objective
        self.early_stopping_rounds = early_stopping_rounds
        self.seed = seed
        self.trees: List[_Tree] = []
        self.base_: float = 0.0
        self.bin_edges_: Optional[List[np.ndarray]] = None
        self._packed = None  # (F, TH, L, R, V) ensemble arrays
        # binned-row -> prediction memo (see module docstring); stats are
        # exposed for perf telemetry/tests, never consulted for results
        self._memo: dict = {}
        self.memo_hits = 0
        self.memo_misses = 0
        # bumped on every fit/continue_fit so decision-level memos above
        # the predictor can detect ensemble mutation cheaply
        self.version = 0

    # -- binning --------------------------------------------------------
    def _make_bins(self, X: np.ndarray) -> None:
        self.bin_edges_ = []
        for f in range(X.shape[1]):
            qs = np.quantile(X[:, f], np.linspace(0, 1, _MAX_BINS + 1)[1:-1])
            self.bin_edges_.append(np.unique(qs))

    def _bin(self, X: np.ndarray) -> np.ndarray:
        B = np.empty(X.shape, np.uint8)
        for f, edges in enumerate(self.bin_edges_):
            B[:, f] = np.searchsorted(edges, X[:, f], side="right").astype(
                np.uint8
            )
        return B

    # -- fitting ----------------------------------------------------------
    def fit(
        self,
        X: np.ndarray,
        y: np.ndarray,
        eval_set: Optional[tuple] = None,
    ) -> "GBTree":
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        self._make_bins(X)
        B = self._bin(X)
        rng = np.random.default_rng(self.seed)
        self.base_ = float(
            np.median(y) if self.objective == "mae" else y.mean()
        )
        self.trees = []
        pred = np.full(y.shape, self.base_)
        Bv = yv = predv = None
        if eval_set is not None:
            Xv, yv = eval_set
            Bv = self._bin(np.asarray(Xv, np.float64))
            predv = np.full(len(yv), self.base_)
        best_mae, best_n, since = np.inf, 0, 0
        n = len(y)
        for _ in range(self.n_estimators):
            res = y - pred
            if self.subsample < 1.0:
                sel = rng.random(n) < self.subsample
                tree = _fit_tree(
                    B[sel], res[sel], self.max_depth, self.min_leaf,
                    self.objective, rng, self.colsample,
                )
            else:
                tree = _fit_tree(
                    B, res, self.max_depth, self.min_leaf, self.objective,
                    rng, self.colsample,
                )
            self.trees.append(tree)
            pred += self.learning_rate * tree.predict_binned(B)
            if Bv is not None:
                predv += self.learning_rate * tree.predict_binned(Bv)
                mae = float(np.abs(yv - predv).mean())
                if mae < best_mae - 1e-12:
                    best_mae, best_n, since = mae, len(self.trees), 0
                else:
                    since += 1
                    if since >= self.early_stopping_rounds:
                        self.trees = self.trees[:best_n]
                        break
        self._memo = {}
        self._packed = None
        self.version += 1
        return self

    def continue_fit(
        self, X: np.ndarray, y: np.ndarray, n_more: int = 40
    ) -> "GBTree":
        """Online adaptation (§V-D): boost additional trees on new samples,
        keeping the offline ensemble and bin layout."""
        assert self.bin_edges_ is not None, "fit() first"
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        B = self._bin(X)
        rng = np.random.default_rng(self.seed + len(self.trees))
        pred = self.predict_binned(B)
        n = len(y)
        for _ in range(n_more):
            res = y - pred
            sel = (
                rng.random(n) < self.subsample
                if self.subsample < 1.0
                else np.ones(n, bool)
            )
            tree = _fit_tree(
                B[sel], res[sel], self.max_depth, self.min_leaf,
                self.objective, rng, self.colsample,
            )
            self.trees.append(tree)
            pred += self.learning_rate * tree.predict_binned(B)
        self._memo = {}
        self._packed = None
        self.version += 1
        return self

    # -- prediction -------------------------------------------------------
    def _pack(self):
        """Pad every tree to the same node count and stack into arrays."""
        maxn = max(len(t.feature) for t in self.trees)
        T = len(self.trees)
        F = np.full((T, maxn), -1, np.int32)
        TH = np.zeros((T, maxn), np.uint8)
        L = np.zeros((T, maxn), np.int32)
        R = np.zeros((T, maxn), np.int32)
        V = np.zeros((T, maxn), np.float64)
        for i, t in enumerate(self.trees):
            n = len(t.feature)
            F[i, :n] = t.feature
            TH[i, :n] = t.threshold
            L[i, :n] = t.left
            R[i, :n] = t.right
            V[i, :n] = t.value
        self._packed = (F, TH, L, R, V)

    _MEMO_CAP = 1 << 16  # distinct binned rows kept before a reset

    def _eval_binned(self, B: np.ndarray) -> np.ndarray:
        """The packed level-synchronous ensemble walk (uncached)."""
        if self._packed is None or self._packed[0].shape[0] != len(self.trees):
            self._pack()
        F, TH, L, R, V = self._packed
        n, T = B.shape[0], F.shape[0]
        tr = np.arange(T)[None, :]  # (1, T)
        node = np.zeros((n, T), np.int32)
        rows = np.arange(n)[:, None]
        for _ in range(self.max_depth + 1):
            f = F[tr, node]  # (n, T)
            leaf = f < 0
            if leaf.all():
                break
            fv = B[rows, np.maximum(f, 0)]  # feature bin per (sample, tree)
            go_left = fv <= TH[tr, node]
            nxt = np.where(go_left, L[tr, node], R[tr, node])
            node = np.where(leaf, node, nxt)
        return self.base_ + self.learning_rate * V[tr, node].sum(axis=1)

    def predict_binned(self, B: np.ndarray) -> np.ndarray:
        if not self.trees:
            return np.full(B.shape[0], self.base_)
        memo = self._memo
        keys = [row.tobytes() for row in B]
        out = np.empty(B.shape[0], np.float64)
        miss: List[int] = []
        for i, key in enumerate(keys):
            v = memo.get(key)
            if v is None:
                miss.append(i)
            else:
                out[i] = v
        self.memo_hits += B.shape[0] - len(miss)
        self.memo_misses += len(miss)
        if miss:
            vals = self._eval_binned(
                B if len(miss) == B.shape[0] else B[miss]
            )
            if len(memo) + len(miss) > self._MEMO_CAP:
                memo.clear()
            for j, i in enumerate(miss):
                memo[keys[i]] = out[i] = vals[j]
        return out

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.atleast_2d(np.asarray(X, np.float64))
        return self.predict_binned(self._bin(X))

    def predict_f64(self, X: np.ndarray) -> np.ndarray:
        """Matrix fast path: ``X`` must already be a C-contiguous float64
        ``(n, d)`` array (the batched what-if builders construct exactly
        that), skipping the ``asarray``/``atleast_2d`` checks of
        :meth:`predict`.  Same bins, same memo — bit-identical results."""
        return self.predict_binned(self._bin(X))
