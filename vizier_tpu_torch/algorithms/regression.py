"""Trial-curve regression: predict final objectives from partial curves.

Copy of the JAX package's ``algorithms/regression.py`` (host numpy): fit a
regression model over completed trials' intermediate-measurement curves,
predict the final objective of active or stopped trials from their partial
curves, and "hallucinate" final measurements for early-stopped trials so
designers can learn from them. The curve is resampled onto a fixed
relative-step grid, so feature vectors have one shape whatever the
measurement cadence.

The JAX package fits scikit-learn's ``GradientBoostingRegressor`` at its
defaults; this module carries its own numpy copy of that model (squared
error, learning rate 0.1, depth-3 trees split on the squared-error
criterion, float32 features), so the port needs no scikit-learn. The trees
visit features in the order scikit-learn's splitter draws them from the same
seed, so both pick the same splits; sums of the same values in another order
may round apart, which decides only between splits of exactly equal gain.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from vizier_tpu_torch.pyvizier import trial as trial_


@dataclasses.dataclass
class TrialData:
    """A trial's objective curve, sorted/deduped by step."""

    id: int
    parameters: Dict[str, float]
    steps: List[float]
    objective_values: List[float]

    @classmethod
    def from_trial(
        cls, trial: trial_.Trial, metric_name: str
    ) -> Optional["TrialData"]:
        """Extracts the intermediate curve; None if no usable measurements."""
        raw = [
            (float(m.steps), float(m.metrics[metric_name].value))
            for m in trial.measurements
            if metric_name in m.metrics
        ]
        # Measurement.steps defaults to 0.0; when the caller never set it,
        # every point lands on one step — fall back to arrival order.
        if len(raw) > 1 and len({s for s, _ in raw}) == 1:
            raw = [(float(i), v) for i, (_, v) in enumerate(raw)]
        points: Dict[float, float] = dict(raw)
        if (
            trial.final_measurement is not None
            and metric_name in trial.final_measurement.metrics
        ):
            fm = trial.final_measurement
            step = float(fm.steps)
            # Default steps=0.0 on the final measurement: it IS the last
            # point, so place it after the curve rather than at step 0.
            if points and step <= max(points) and step == 0.0:
                step = max(points) + 1.0
            points[step] = float(fm.metrics[metric_name].value)
        if not points:
            return None
        steps = sorted(points)
        params = {}
        for name, value in trial.parameters.items():
            try:
                params[name] = float(value.value)
            except (TypeError, ValueError):
                params[name] = float(hash(str(value.value)) % 997) / 997.0
        return cls(
            id=trial.id,
            parameters=params,
            steps=steps,
            objective_values=[points[s] for s in steps],
        )

    def value_at(self, step: float) -> float:
        """Piecewise-linear interpolation (clamped at the curve's ends)."""
        return float(np.interp(step, self.steps, self.objective_values))

    def extrapolate_objective_value(self, max_num_steps: float) -> float:
        """Extends the curve to ``max_num_steps`` with its final slope."""
        if len(self.steps) < 2 or self.steps[-1] >= max_num_steps:
            return self.objective_values[-1]
        slope = (self.objective_values[-1] - self.objective_values[-2]) / max(
            self.steps[-1] - self.steps[-2], 1e-9
        )
        return self.objective_values[-1] + slope * (max_num_steps - self.steps[-1])

    def resampled(self, fractions: Sequence[float]) -> np.ndarray:
        """Curve values at relative positions of the trial's own step range."""
        lo, hi = self.steps[0], self.steps[-1]
        grid = [lo + f * (hi - lo) for f in fractions]
        return np.array([self.value_at(g) for g in grid])


# scikit-learn's tree constants: the largest value of its random stream, the
# gap below which two float32 feature values count as equal, and the
# impurity below which a node is a leaf.
_RAND_R_MAX = 0x7FFFFFFF
_FEATURE_THRESHOLD = np.float32(1e-7)
_EPSILON = np.finfo(np.float64).eps


def _rand_int(state: List[int], low: int, high: int) -> int:
    """scikit-learn's ``rand_int`` over its xorshift stream ``state[0]``."""
    s = state[0] or 1
    s ^= (s << 13) & 0xFFFFFFFF
    s ^= s >> 17
    s ^= (s << 5) & 0xFFFFFFFF
    state[0] = s
    return low + (s % (_RAND_R_MAX + 1)) % (high - low)


def _introsort(values: list, index: list, lo: int, n: int, maxd: int) -> None:
    """scikit-learn's 3-way-partition introsort of ``values[lo:lo + n]``,
    carrying ``index`` along. The order it leaves equal values in decides
    how the split search's sums round, so it is copied step for step."""
    while n > 15:
        if maxd <= 0:
            _heapsort(values, index, lo, n)
            return
        maxd -= 1
        a, b, c = values[lo], values[lo + n // 2], values[lo + n - 1]
        if a < b:
            pivot = b if b < c else (c if a < c else a)
        elif b < c:
            pivot = a if a < c else c
        else:
            pivot = b
        i = l = lo
        r = lo + n
        while i < r:
            v = values[i]
            if v < pivot:
                values[i], values[l] = values[l], v
                index[i], index[l] = index[l], index[i]
                i += 1
                l += 1
            elif v > pivot:
                r -= 1
                values[i], values[r] = values[r], v
                index[i], index[r] = index[r], index[i]
            else:
                i += 1
        _introsort(values, index, lo, l - lo, maxd)
        n -= r - lo
        lo = r
    for i in range(lo + 1, lo + n):
        v, k = values[i], index[i]
        j = i
        while j > lo and values[j - 1] > v:
            values[j], index[j] = values[j - 1], index[j - 1]
            j -= 1
        values[j], index[j] = v, k


def _heapsort(values: list, index: list, lo: int, n: int) -> None:
    def sift_down(root: int, end: int) -> None:
        while True:
            child, top = 2 * root + 1, root
            if child < end and values[lo + top] < values[lo + child]:
                top = child
            if child + 1 < end and values[lo + top] < values[lo + child + 1]:
                top = child + 1
            if top == root:
                return
            a, b = lo + root, lo + top
            values[a], values[b] = values[b], values[a]
            index[a], index[b] = index[b], index[a]
            root = top

    start = (n - 2) // 2
    while True:
        sift_down(start, n)
        if start == 0:
            break
        start -= 1
    for end in range(n - 1, 0, -1):
        values[lo], values[lo + end] = values[lo + end], values[lo]
        index[lo], index[lo + end] = index[lo + end], index[lo]
        sift_down(0, end)


def _sort_samples(values: np.ndarray, samples: np.ndarray) -> np.ndarray:
    """``samples`` reordered as scikit-learn's introsort orders them by
    ``values``: by a plain sort when no two values are equal (the order is
    then unique), else step for step."""
    n = len(values)
    if len(np.unique(values)) == n:
        return samples[np.argsort(values)]
    vals, index = values.tolist(), samples.tolist()
    _introsort(vals, index, 0, n, 2 * int(np.log2(n)))
    return np.asarray(index, dtype=samples.dtype)


def _seq_sum(values: np.ndarray, start: float = 0.0) -> float:
    """``start`` plus ``values`` added one by one, in order."""
    if not len(values):
        return start
    return float(np.cumsum(np.concatenate([[start], values]))[-1])


@dataclasses.dataclass
class _Tree:
    """A fitted regression tree: per node its feature (-1 on a leaf),
    threshold, children and value."""

    feature: np.ndarray
    threshold: np.ndarray
    left: np.ndarray
    right: np.ndarray
    value: np.ndarray

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Leaf values at float32 rows ``x`` [N, F] (``x <= threshold`` goes left)."""
        node = np.zeros(len(x), dtype=np.int64)
        rows = np.arange(len(x))
        while True:
            inner = self.feature[node] >= 0
            if not inner.any():
                return self.value[node]
            f = np.where(inner, self.feature[node], 0)
            go_left = x[rows, f].astype(np.float64) <= self.threshold[node]
            child = np.where(go_left, self.left[node], self.right[node])
            node = np.where(inner, child, node)


class _Node(NamedTuple):
    """The squared-error criterion's sums over a node's samples, in their
    order at the node."""

    total: float
    sq_total: float
    n: float

    @classmethod
    def of(cls, y: np.ndarray) -> "_Node":
        return cls(_seq_sum(y), _seq_sum(y * y), float(len(y)))

    @property
    def impurity(self) -> float:
        return self.sq_total / self.n - (self.total / self.n) ** 2.0


def _left_sums(y: np.ndarray, cuts: np.ndarray, total: float) -> np.ndarray:
    """The criterion's left sum at each split position ``cuts`` (increasing),
    as scikit-learn's ``update`` reaches it from the previous position:
    adding the samples in between, or, when fewer lie to the right, starting
    again from the node's total and subtracting the samples right of it."""
    n = len(y)
    prev = np.concatenate([[0], cuts[:-1]])
    backward = (cuts - prev) > (n - cuts)
    out = np.cumsum(y)[cuts - 1]
    if not backward.any():
        return out
    k = int(np.argmax(backward))
    left = float(out[k - 1]) if k else 0.0
    for j in range(k, len(cuts)):
        pos, new = int(prev[j]), int(cuts[j])
        if new - pos <= n - new:
            left = _seq_sum(y[pos:new], left)
        else:
            left = float(np.subtract.accumulate(np.concatenate([[total], y[new:][::-1]]))[-1])
        out[j] = left
    return out


def _best_split(x: np.ndarray, y: np.ndarray, samples: np.ndarray, node: _Node,
                features: np.ndarray, constant: np.ndarray, n_known: int, state: List[int]):
    """scikit-learn's best splitter on one node's ``samples`` (reordered in
    place, as its sorts and its final partition reorder them): features are
    drawn without replacement by its Fisher-Yates walk over ``features``
    (also permuted in place), skipping the ``n_known`` constant ones; each
    non-constant feature's positions between distinct values are scored by
    the squared-error proxy sum_l²/n_l + sum_r²/n_r and the first best kept.
    Returns (feature, threshold, split position or None, constant count)."""
    n = len(samples)
    n_features = len(features)
    best_proxy, best = -np.inf, None
    f_i, n_found, n_drawn, n_total = n_features, 0, 0, n_known
    visited = 0
    while f_i > n_total and (visited < n_features or visited <= n_found + n_drawn):
        visited += 1
        f_j = _rand_int(state, n_drawn, f_i - n_found)
        if f_j < n_known:
            features[n_drawn], features[f_j] = features[f_j], features[n_drawn]
            n_drawn += 1
            continue
        f_j += n_found
        feature = int(features[f_j])
        samples[:] = _sort_samples(x[samples, feature], samples)
        values = x[samples, feature]
        if values[-1] <= values[0] + _FEATURE_THRESHOLD:
            features[f_j], features[n_total] = features[n_total], features[f_j]
            n_found += 1
            n_total += 1
            continue
        f_i -= 1
        features[f_i], features[f_j] = features[f_j], features[f_i]
        cuts = np.nonzero(values[1:] > values[:-1] + _FEATURE_THRESHOLD)[0] + 1
        left = _left_sums(y[samples], cuts, node.total)
        right = node.total - left
        proxy = left * left / cuts + right * right / (n - cuts)
        k = int(np.argmax(proxy))
        if proxy[k] > best_proxy:
            best_proxy = float(proxy[k])
            p = int(cuts[k])
            best = (feature, float(values[p - 1]) / 2.0 + float(values[p]) / 2.0)
    # The constant features found here go to the list the children skip, in
    # the order they were found; the known ones keep their order.
    constant[n_known:n_total] = features[n_known:n_total]
    features[:n_known] = constant[:n_known]
    if best is None:
        return None, None, None, n_total
    feature, threshold = best
    # scikit-learn's in-place partition: a sample going right swaps with
    # the last unread one.
    order = samples.tolist()
    lo, hi = 0, n
    while lo < hi:
        if float(x[order[lo], feature]) <= threshold:
            lo += 1
        else:
            hi -= 1
            order[lo], order[hi] = order[hi], order[lo]
    samples[:] = order
    return feature, threshold, lo, n_total


def _children(y: np.ndarray, pos: int, node: _Node) -> Tuple[float, float]:
    """The children's impurities as scikit-learn computes them after the
    split: the left sums from a fresh start, the right ones by difference."""
    n = len(y)
    left = float(_left_sums(y, np.asarray([pos]), node.total)[0])
    sq_left = _seq_sum(y[:pos] * y[:pos])
    wl, wr = float(pos), float(n - pos)
    right = node.total - left
    return (sq_left / wl - (left / wl) ** 2.0,
            (node.sq_total - sq_left) / wr - (right / wr) ** 2.0)


def _fit_tree(x: np.ndarray, y: np.ndarray, max_depth: int, seed: int) -> _Tree:
    """A depth-first regression tree on the squared-error criterion, as
    scikit-learn's ``DecisionTreeRegressor(max_depth=max_depth)`` builds it
    with its splitter's stream seeded by ``seed``."""
    n, n_features = x.shape
    samples = np.arange(n)
    features = np.arange(n_features)
    constant = np.zeros(n_features, dtype=np.int64)
    state = [seed]
    nodes: List[list] = []  # [feature, threshold, left, right, value]
    # (start, end, depth, parent, is_left, impurity, n_constant)
    stack = [(0, n, 0, -1, False, None, 0)]
    while stack:
        start, end, depth, parent, is_left, impurity, n_known = stack.pop()
        node = _Node.of(y[samples[start:end]])
        if impurity is None:
            impurity = node.impurity
        is_leaf = depth >= max_depth or end - start < 2 or impurity <= _EPSILON
        pos = None
        if not is_leaf:
            feature, threshold, pos, n_known = _best_split(
                x, y, samples[start:end], node, features, constant, n_known, state)
            is_leaf = pos is None
        node_id = len(nodes)
        nodes.append([-1, 0.0, -1, -1, node.total / node.n])
        if parent >= 0:
            nodes[parent][2 if is_left else 3] = node_id
        if not is_leaf:
            nodes[node_id][:2] = [feature, threshold]
            left, right = _children(y[samples[start:end]], pos, node)
            split = start + pos
            stack.append((split, end, depth + 1, node_id, False, right, n_known))
            stack.append((start, split, depth + 1, node_id, True, left, n_known))
    columns = list(zip(*nodes))
    return _Tree(np.asarray(columns[0], np.int64), np.asarray(columns[1], np.float64),
                 np.asarray(columns[2], np.int64), np.asarray(columns[3], np.int64),
                 np.asarray(columns[4], np.float64))


@dataclasses.dataclass
class GradientBoostingRegressor:
    """Least-squares gradient boosting, as scikit-learn's
    ``GradientBoostingRegressor(n_estimators, random_state)`` at its other
    defaults: the mean as the initial prediction, then each tree fitted to
    the residuals and added at ``learning_rate``. Each tree's splitter
    stream is seeded by ``RandomState(random_state).randint(0, 2**31 - 1)``
    drawn in turn, as scikit-learn seeds it."""

    n_estimators: int = 100
    learning_rate: float = 0.1
    max_depth: int = 3
    random_state: int = 0

    def fit(self, x: np.ndarray, y: np.ndarray) -> "GradientBoostingRegressor":
        x = np.asarray(x, dtype=np.float32)
        y = np.asarray(y, dtype=np.float64)
        rng = np.random.RandomState(self.random_state)
        self._init = float(np.average(y, weights=np.ones_like(y)))
        raw = np.full(len(y), self._init)
        self._trees = []
        for _ in range(self.n_estimators):
            tree = _fit_tree(x, -(raw - y), self.max_depth, int(rng.randint(0, _RAND_R_MAX)))
            raw += self.learning_rate * tree.predict(x)
            self._trees.append(tree)
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float32)
        out = np.full(len(x), self._init)
        for tree in self._trees:
            out = out + self.learning_rate * tree.predict(x)
        return out


_CURVE_GRID = tuple(np.linspace(0.0, 1.0, 8))


@dataclasses.dataclass
class GBMAutoRegressor:
    """Gradient-boosted regressor: (params, partial curve) → final objective.

    Training samples are generated by truncating each completed trial's
    curve at several fractions, so the model learns to map any prefix length
    to the final value (an auto-regressive scheme).
    """

    metric_name: str
    num_estimators: int = 100
    truncation_fractions: Sequence[float] = (0.25, 0.5, 0.75, 1.0)
    min_train_trials: int = 5
    seed: int = 0

    def __post_init__(self):
        self._model = None
        self._param_names: List[str] = []

    @property
    def is_trained(self) -> bool:
        return self._model is not None

    def _features(self, data: TrialData, fraction: float) -> np.ndarray:
        lo, hi = data.steps[0], data.steps[-1]
        cut = lo + fraction * (hi - lo)
        prefix = TrialData(
            id=data.id,
            parameters=data.parameters,
            steps=[s for s in data.steps if s <= cut] or data.steps[:1],
            objective_values=data.objective_values[
                : max(1, sum(1 for s in data.steps if s <= cut))
            ],
        )
        params = [data.parameters.get(n, 0.0) for n in self._param_names]
        return np.concatenate(
            [params, prefix.resampled(_CURVE_GRID), [fraction, hi]]
        )

    def train(self, completed: Sequence[trial_.Trial]) -> bool:
        """Fits the model; returns False when there is too little data."""
        datas = [
            d
            for t in completed
            if (d := TrialData.from_trial(t, self.metric_name)) is not None
        ]
        if len(datas) < self.min_train_trials:
            return False
        self._param_names = sorted({n for d in datas for n in d.parameters})
        xs, ys = [], []
        for d in datas:
            target = d.objective_values[-1]
            for f in self.truncation_fractions:
                xs.append(self._features(d, f))
                ys.append(target)
        self._model = GradientBoostingRegressor(
            n_estimators=self.num_estimators, random_state=self.seed
        )
        self._model.fit(np.stack(xs), np.asarray(ys))
        return True

    def predict(self, trial: trial_.Trial) -> Optional[float]:
        """Predicted final objective from the trial's partial curve."""
        if not self.is_trained:
            return None
        data = TrialData.from_trial(trial, self.metric_name)
        if data is None:
            return None
        return float(self._model.predict(self._features(data, 1.0)[None, :])[0])


@dataclasses.dataclass
class TrialHallucinator:
    """Completes early-stopped trials with regressed final measurements.

    Stopped trials carry
    information in their partial curves; hallucinating their final values
    lets designers exploit them instead of discarding the compute.
    """

    metric_name: str
    regressor: Optional[GBMAutoRegressor] = None

    def __post_init__(self):
        if self.regressor is None:
            self.regressor = GBMAutoRegressor(self.metric_name)

    def train(self, completed: Sequence[trial_.Trial]) -> bool:
        return self.regressor.train(completed)

    def hallucinate_final_measurements(
        self, stopped: Sequence[trial_.Trial]
    ) -> List[trial_.Trial]:
        """Returns completed copies of the stopped trials (skips unfittable)."""
        out = []
        for t in stopped:
            pred = self.regressor.predict(t)
            if pred is None:
                continue
            filled = trial_.Trial(
                id=t.id,
                parameters={k: v.value for k, v in t.parameters.items()},
            )
            for m in t.measurements:
                filled.measurements.append(m)
            filled.complete(
                trial_.Measurement(metrics={self.metric_name: pred})
            )
            filled.metadata.ns("regression")["hallucinated"] = "True"
            out.append(filled)
        return out
