"""A small random forest in numpy, for the OBIA pseudo-labeler (the JAX
package's ``tools/obia.py`` uses sklearn's ``RandomForestClassifier``).

``DecisionTree`` is CART with the Gini impurity, grown depth first (left
subtree first) to pure leaves, as sklearn's ``DecisionTreeClassifier``
grows it:

  * the features are cast to float32;
  * at a node the candidate features are visited in the order of sklearn's
    Fisher-Yates draw over one feature permutation kept across nodes, from
    its xorshift generator seeded ``RandomState(seed).randint(0, 2**31 -
    1)``; a feature found constant (max <= min + 1e-7) is set aside for the
    node's subtree and does not count;
  * a feature's values are sorted, every position between two values more
    than 1e-7 apart is a candidate, and the split maximises sklearn's Gini
    proxy ``-n_right * gini_right - n_left * gini_left``: the first
    position in sorted order on a tie, and the first feature visited;
  * the threshold is the midpoint of the two values in float64 (the lower
    value where rounding lands the midpoint on the upper one), and a row
    goes left when its value is ``<=`` it;
  * a leaf predicts its class frequencies.

With ``max_features=None`` every feature is a candidate at every node; an
int or "sqrt" visits that many (more where some are constant).

``RandomForest`` fits ``n_estimators`` trees, each on a bootstrap sample
(n rows drawn with replacement) with ``max_features="sqrt"`` and its own
seed, all from one ``numpy.random.default_rng(seed)``, and predicts the
argmax of the mean class frequencies.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np

_THRESHOLD = 1e-7  # values closer than this are not split (sklearn's FEATURE_THRESHOLD)
_RAND_R_MAX = 2147483647


class _XorShift:
    """sklearn's ``our_rand_r`` and ``rand_int`` (tree/_utils.pyx)."""

    def __init__(self, seed: int):
        self.state = int(np.random.RandomState(seed).randint(0, _RAND_R_MAX))

    def rand_int(self, low: int, high: int) -> int:
        s = self.state or 1
        s ^= (s << 13) & 0xFFFFFFFF
        s ^= s >> 17
        s ^= (s << 5) & 0xFFFFFFFF
        self.state = s
        return low + (s % (_RAND_R_MAX + 1)) % (high - low)


def _n_features(max_features: Union[None, int, str], n: int) -> int:
    if max_features is None:
        return n
    if max_features == "sqrt":
        return max(1, int(np.sqrt(n)))
    return max(1, min(int(max_features), n))


class DecisionTree:
    """``fit(X, y)`` with ``y`` class indices in ``range(n_classes)``;
    ``predict_proba(X)`` -> (n, n_classes)."""

    def __init__(self, max_features: Union[None, int, str] = None, seed: int = 0):
        self.max_features = max_features
        self.seed = seed

    def fit(self, X: np.ndarray, y: np.ndarray, n_classes: Optional[int] = None):
        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.int64)
        self.n_classes = int(n_classes if n_classes is not None else y.max() + 1)
        # flat node arrays: feature (-1 for a leaf), threshold, children, value
        self.feature, self.threshold, self.left, self.right, self.value = [], [], [], [], []
        k = _n_features(self.max_features, X.shape[1])
        self._rand = _XorShift(self.seed)
        self._features = list(range(X.shape[1]))
        self._constant = list(range(X.shape[1]))
        stack = [(np.arange(len(y)), None, False, 0)]
        while stack:
            idx, parent, is_left, n_known = stack.pop()
            node = len(self.feature)
            if parent is not None:
                (self.left if is_left else self.right)[parent] = node
            counts = np.bincount(y[idx], minlength=self.n_classes).astype(np.float64)
            self.feature.append(-1)
            self.threshold.append(0.0)
            self.left.append(-1)
            self.right.append(-1)
            self.value.append(counts / counts.sum())
            if len(idx) < 2 or np.count_nonzero(counts) <= 1:
                continue
            split, n_known = self._best_split(X[idx], y[idx], k, n_known)
            if split is None:
                continue
            f, thr = split
            go_left = X[idx, f] <= thr
            self.feature[node], self.threshold[node] = f, thr
            # depth first, left subtree first: push the right child below it
            stack.append((idx[~go_left], node, False, n_known))
            stack.append((idx[go_left], node, True, n_known))
        self.feature = np.asarray(self.feature)
        self.threshold = np.asarray(self.threshold)
        self.left, self.right = np.asarray(self.left), np.asarray(self.right)
        self.value = np.stack(self.value)
        return self

    def _best_split(self, X: np.ndarray, y: np.ndarray, k: int, n_known: int):
        """sklearn's ``node_split_best``.  Returns ((feature, threshold) or
        None, the number of constant features for the children)."""
        n, n_feat = X.shape
        features, constant = self._features, self._constant
        onehot = np.eye(self.n_classes)[y]
        n_left = np.arange(1, n, dtype=np.float64)
        n_right = n - n_left
        best, best_score = None, -np.inf
        f_i, n_visited, n_found, n_drawn, n_total = n_feat, 0, 0, 0, n_known
        while f_i > n_total and (n_visited < k or n_visited <= n_found + n_drawn):
            n_visited += 1
            f_j = self._rand.rand_int(n_drawn, f_i - n_found)
            if f_j < n_known:  # a constant one, known from an ancestor
                features[n_drawn], features[f_j] = features[f_j], features[n_drawn]
                n_drawn += 1
                continue
            f_j += n_found
            f = features[f_j]
            order = np.argsort(X[:, f], kind="stable")
            xs = X[order, f].astype(np.float64)
            if xs[-1] <= xs[0] + _THRESHOLD:  # constant at this node
                features[f_j], features[n_total] = features[n_total], features[f_j]
                n_found += 1
                n_total += 1
                continue
            f_i -= 1
            features[f_i], features[f_j] = features[f_j], features[f_i]
            valid = xs[1:] > xs[:-1] + _THRESHOLD
            left = np.cumsum(onehot[order], axis=0)[:-1]  # counts left of position p + 1
            right = left[-1] + onehot[order[-1]] - left
            gini_l = 1.0 - np.sum(left * left, axis=1) / (n_left * n_left)
            gini_r = 1.0 - np.sum(right * right, axis=1) / (n_right * n_right)
            score = np.where(valid, -n_right * gini_r - n_left * gini_l, -np.inf)
            p = int(np.argmax(score))
            if score[p] > best_score:
                lo, hi = float(xs[p]), float(xs[p + 1])
                thr = lo / 2.0 + hi / 2.0
                if thr == hi or not np.isfinite(thr):
                    thr = lo
                best, best_score = (int(f), thr), score[p]
        # the constants known from the ancestors keep their order for the
        # subtree; the ones found here join them
        features[:n_known] = constant[:n_known]
        constant[n_known:n_total] = features[n_known:n_total]
        return best, n_total

    def apply(self, X: np.ndarray) -> np.ndarray:
        """The leaf each row lands in."""
        X = np.asarray(X, np.float32)
        node = np.zeros(len(X), np.int64)
        active = self.feature[node] >= 0
        while active.any():
            rows = np.nonzero(active)[0]
            nd = node[rows]
            go_left = X[rows, self.feature[nd]] <= self.threshold[nd]
            node[rows] = np.where(go_left, self.left[nd], self.right[nd])
            active = self.feature[node] >= 0
        return node

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        return self.value[self.apply(X)]

    def predict(self, X: np.ndarray) -> np.ndarray:
        return np.argmax(self.predict_proba(X), axis=1)


class RandomForest:
    """``fit(X, y)`` with integer class labels; ``predict(X)`` -> labels."""

    def __init__(self, n_estimators: int = 100, seed: int = 0):
        self.n_estimators = n_estimators
        self.seed = seed

    def fit(self, X: np.ndarray, y: np.ndarray):
        X = np.asarray(X, np.float32)
        self.classes_, y_idx = np.unique(np.asarray(y), return_inverse=True)
        rng = np.random.default_rng(self.seed)
        self.trees = []
        for _ in range(self.n_estimators):
            rows = rng.integers(0, len(X), len(X))
            tree = DecisionTree("sqrt", int(rng.integers(0, _RAND_R_MAX)))
            self.trees.append(tree.fit(X[rows], y_idx[rows], len(self.classes_)))
        return self

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        return np.mean([t.predict_proba(X) for t in self.trees], axis=0)

    def predict(self, X: np.ndarray) -> np.ndarray:
        return self.classes_[np.argmax(self.predict_proba(X), axis=1)]
