"""NASBench-101 experimenter: 7-vertex DAG cell search space.

Parity with
``vizier/_src/benchmarks/experimenters/nasbench101_experimenter.py``:
the search space is the upper-triangular adjacency of a 7-vertex DAG (21
bool params named ``{x}_{y}``) plus one categorical op per interior vertex
(5 spots), and evaluation queries a NASBench-101 API object
(``is_valid``/``query``) — the real ``nasbench`` package when its dataset
is available, or :class:`TabularNASBench101`, a self-contained table
backend keyed by the isomorphism-invariant graph hash.

The graph machinery (pruning unreachable vertices, canonical
neighborhood hashing) is implemented here so the encoding works — and is
testable — without the external package or its 2GB dataset.

Copy of the JAX package's ``benchmarks/experimenters/nasbench101.py``: the
same specs prune and hash the same.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from vizier_tpu_torch.benchmarks.experimenters import base
from vizier_tpu_torch.pyvizier import base_study_config
from vizier_tpu_torch.pyvizier import trial as trial_

NUM_VERTICES = 7
OP_SPOTS = NUM_VERTICES - 2
MAX_EDGES = 9
INPUT_OP = "input"
OUTPUT_OP = "output"
ALLOWED_OPS = ("conv3x3-bn-relu", "conv1x1-bn-relu", "maxpool3x3")
METRIC_NAMES = (
    "trainable_parameters",
    "training_time",
    "train_accuracy",
    "validation_accuracy",
    "test_accuracy",
)


@dataclasses.dataclass
class ModelSpec:
    """A NASBench-101 cell: DAG adjacency matrix + per-vertex op labels.

    ``matrix``: [V, V] upper-triangular 0/1 (edge x→y iff ``matrix[x, y]``);
    ``ops``: length-V labels, ``ops[0] == "input"``, ``ops[-1] == "output"``.
    """

    matrix: np.ndarray
    ops: List[str]

    def __post_init__(self):
        self.matrix = np.asarray(self.matrix, dtype=int)
        v = self.matrix.shape[0]
        if self.matrix.shape != (v, v) or len(self.ops) != v:
            raise ValueError("matrix must be [V, V] with V op labels.")
        if np.any(np.tril(self.matrix)):
            raise ValueError("matrix must be strictly upper-triangular (a DAG).")
        # Memoized derived values (specs are treated as immutable once
        # built; evaluate loops prune/hash each spec several times).
        self._pruned_cache: Optional[Tuple["ModelSpec"]] = None
        self._hash_cache: Optional[str] = None

    def pruned(self) -> Optional["ModelSpec"]:
        """Removes vertices not on any input→output path.

        Returns None when input and output are disconnected (the cell
        computes nothing — invalid in NASBench-101).
        """
        if self._pruned_cache is not None:
            return self._pruned_cache[0]
        result = self._prune()
        self._pruned_cache = (result,)
        return result

    def _prune(self) -> Optional["ModelSpec"]:
        v = self.matrix.shape[0]
        # Forward reachability from input (vertex 0).
        fwd = {0}
        frontier = [0]
        while frontier:
            x = frontier.pop()
            for y in np.nonzero(self.matrix[x])[0]:
                if y not in fwd:
                    fwd.add(int(y))
                    frontier.append(int(y))
        # Backward reachability from output (vertex V-1).
        bwd = {v - 1}
        frontier = [v - 1]
        while frontier:
            y = frontier.pop()
            for x in np.nonzero(self.matrix[:, y])[0]:
                if x not in bwd:
                    bwd.add(int(x))
                    frontier.append(int(x))
        keep = sorted(fwd & bwd)
        if 0 not in keep or (v - 1) not in keep:
            return None
        idx = np.asarray(keep)
        return ModelSpec(
            matrix=self.matrix[np.ix_(idx, idx)],
            ops=[self.ops[i] for i in keep],
        )

    def graph_hash(self) -> str:
        """Isomorphism-invariant hash of the PRUNED (matrix, ops) graph.

        Iterative neighborhood hashing: every vertex starts from
        (in-degree, out-degree, op) and repeatedly absorbs the sorted
        hashes of its in- and out-neighborhoods; the final digest is the
        hash of the sorted vertex hashes, so any vertex relabeling of the
        same computation graph maps to the same key.
        """
        if self._hash_cache is not None:
            return self._hash_cache
        self._hash_cache = self._compute_hash()
        return self._hash_cache

    def _compute_hash(self) -> str:
        spec = self.pruned()
        if spec is None:
            return "invalid"
        m, ops = spec.matrix, spec.ops
        v = m.shape[0]
        in_deg = m.sum(axis=0)
        out_deg = m.sum(axis=1)
        hashes = [
            hashlib.md5(
                f"{int(in_deg[i])}|{int(out_deg[i])}|{ops[i]}".encode()
            ).hexdigest()
            for i in range(v)
        ]
        for _ in range(v):
            hashes = [
                hashlib.md5(
                    (
                        "".join(sorted(hashes[x] for x in np.nonzero(m[:, i])[0]))
                        + "|"
                        + "".join(sorted(hashes[y] for y in np.nonzero(m[i])[0]))
                        + "|"
                        + hashes[i]
                    ).encode()
                ).hexdigest()
                for i in range(v)
            ]
        return hashlib.md5("".join(sorted(hashes)).encode()).hexdigest()


class TabularNASBench101:
    """Table-backed NASBench-101 API: graph-hash → metrics dict.

    Duck-type compatible with the ``nasbench`` package's API object
    (``is_valid``/``query``) so :class:`NASBench101Experimenter` works
    against either. The table file is a JSON mapping graph hashes (as
    produced by :meth:`ModelSpec.graph_hash`) to metric dicts.
    """

    def __init__(self, table: Dict[str, Dict[str, float]]):
        self._table = table

    @classmethod
    def from_file(cls, path: str) -> "TabularNASBench101":
        if not path or not os.path.exists(path):
            raise FileNotFoundError(
                f"NASBench-101 table not found at {path!r}. Export the "
                "dataset to a hash→metrics JSON; the repository ships no "
                "benchmark data."
            )
        with open(path) as f:
            return cls(json.load(f))

    def is_valid(self, spec: ModelSpec) -> bool:
        pruned = spec.pruned()
        if pruned is None:
            return False
        if pruned.matrix.sum() > MAX_EDGES:
            return False
        if pruned.matrix.shape[0] > NUM_VERTICES:
            return False
        if any(
            op not in ALLOWED_OPS for op in pruned.ops[1:-1]
        ) or pruned.ops[0] != INPUT_OP or pruned.ops[-1] != OUTPUT_OP:
            return False
        # Hash the already-pruned spec: pruning is idempotent, so this
        # equals spec.graph_hash() without re-walking the full graph.
        return pruned.graph_hash() in self._table

    def query(self, spec: ModelSpec) -> Dict[str, float]:
        return dict(self._table[spec.graph_hash()])

    def query_by_hash(self, graph_hash: str) -> Dict[str, float]:
        return dict(self._table[graph_hash])


class NASBench101Experimenter(base.Experimenter):
    """NASBench-101: binary DAG edges + categorical convolution ops.

    Reference ``NASBench101Experimenter`` (``nasbench101_experimenter.py``):
    search space is 21 bools (``{x}_{y}`` for the strict upper triangle of a
    7-vertex adjacency) ∪ 5 categorical op spots; invalid graphs complete
    infeasible, valid ones carry all five tabulated metrics.
    """

    def __init__(self, nasbench):
        self._nasbench = nasbench

    def evaluate(self, suggestions: Sequence[trial_.Trial]) -> None:
        for t in suggestions:
            spec = self._trial_to_model_spec(t)
            if self._nasbench.is_valid(spec):
                results = self._nasbench.query(spec)
                t.complete(
                    trial_.Measurement(
                        metrics={k: results[k] for k in METRIC_NAMES}
                    )
                )
            else:
                t.complete(infeasibility_reason="Not in search space.")

    def _trial_to_model_spec(self, t: trial_.Trial) -> ModelSpec:
        matrix = np.zeros((NUM_VERTICES, NUM_VERTICES), dtype=int)
        for y in range(NUM_VERTICES):
            for x in range(NUM_VERTICES):
                if y > x:
                    matrix[x][y] = int(
                        str(t.parameters.get_value(f"{x}_{y}")) == "True"
                    )
        ops = (
            [INPUT_OP]
            + [
                str(t.parameters.get_value(f"ops_{i}"))
                for i in range(OP_SPOTS)
            ]
            + [OUTPUT_OP]
        )
        return ModelSpec(matrix=matrix, ops=ops)

    def problem_statement(self) -> base_study_config.ProblemStatement:
        problem = base_study_config.ProblemStatement()
        root = problem.search_space.root
        for y in range(NUM_VERTICES):
            for x in range(NUM_VERTICES):
                if y > x:
                    root.add_bool_param(name=f"{x}_{y}")
        for i in range(OP_SPOTS):
            root.add_categorical_param(
                name=f"ops_{i}", feasible_values=list(ALLOWED_OPS)
            )
        problem.metric_information.append(
            base_study_config.MetricInformation(
                name="validation_accuracy",
                goal=base_study_config.ObjectiveMetricGoal.MAXIMIZE,
            )
        )
        return problem


def synthetic_nasbench101(
    num_cells: int = 64, seed: int = 0
) -> Tuple[TabularNASBench101, List[ModelSpec]]:
    """A NASBench-101-STYLE table over randomly sampled valid cells.

    Not real NASBench data (none is bundled): random valid specs are hashed
    and assigned a structured synthetic accuracy, so the full experimenter
    pipeline — encode → prune → hash → query — runs end to end in tests.
    Returns (api, the generating specs).
    """
    rng = np.random.default_rng(seed)
    table: Dict[str, Dict[str, float]] = {}
    specs: List[ModelSpec] = []
    while len(table) < num_cells:
        matrix = np.triu(
            (rng.uniform(size=(NUM_VERTICES, NUM_VERTICES)) < 0.35).astype(int), 1
        )
        # Ensure a backbone path so most samples are valid.
        for i in range(NUM_VERTICES - 1):
            if rng.uniform() < 0.8:
                matrix[i, i + 1] = 1
        ops = (
            [INPUT_OP]
            + [ALLOWED_OPS[i] for i in rng.integers(0, len(ALLOWED_OPS), OP_SPOTS)]
            + [OUTPUT_OP]
        )
        spec = ModelSpec(matrix=matrix, ops=ops)
        pruned = spec.pruned()
        if pruned is None or pruned.matrix.sum() > MAX_EDGES:
            continue
        h = spec.graph_hash()
        if h in table:
            continue
        acc = float(
            0.85
            + 0.05 * np.tanh(pruned.matrix.sum() / 4.0)
            + 0.02 * rng.normal()
        )
        table[h] = {
            "trainable_parameters": float(1e6 * (1 + pruned.matrix.sum())),
            "training_time": float(1000.0 + 100.0 * pruned.matrix.shape[0]),
            "train_accuracy": min(acc + 0.05, 1.0),
            "validation_accuracy": acc,
            "test_accuracy": acc - 0.01,
        }
        specs.append(spec)
    return TabularNASBench101(table), specs
