"""PyGlove DNASpec ⇄ vizier search-space / DNA ⇄ trial converters.

Parity with ``vizier/_src/pyglove/converters.py`` (DNASpec
walk ``:101-209``, ``VizierConverter.to_dna/to_trial`` ``:405-527``): PyGlove
genomes are trees — a ``Choices`` decision point holds candidate *subspaces*
whose own decision points only exist when that candidate is chosen, which is
exactly a vizier conditional search space; ``Float`` points map to scaled
double parameters and literal choice values become categorical values.

Everything here is *structural* (duck-typed against the ``pg.geno`` data
model: objects with ``elements`` / ``num_choices`` / ``candidates`` /
``literal_values`` / ``min_value`` / ``max_value``), so the logic is fully
exercised by a structural test double without pyglove installed; with
pyglove installed the same code consumes real ``pg.DNASpec`` / ``pg.DNA``
objects unchanged.

Copy of the JAX package's ``pyglove/converters.py``, on the port's data
model.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

from vizier_tpu_torch import pyvizier as vz

_CUSTOM_PREFIX = "__custom__:"


# ---------------------------------------------------------------------------
# Structural views of the pg.geno data model (duck-typed accessors).
# ---------------------------------------------------------------------------


def _is_space(node: Any) -> bool:
    return hasattr(node, "elements")


def _is_choices(node: Any) -> bool:
    return hasattr(node, "candidates") and hasattr(node, "num_choices")


def _is_float(node: Any) -> bool:
    return hasattr(node, "min_value") and hasattr(node, "max_value")


def _location_key(node: Any, fallback: str) -> str:
    name = getattr(node, "name", None)
    if name:
        return str(name)
    location = getattr(node, "location", None)
    if location is not None and str(location):
        return str(location)
    return fallback


def _space_is_constant(space: Any) -> bool:
    return not getattr(space, "elements", ())


def _scale_type(node: Any) -> Optional[vz.ScaleType]:
    scale = getattr(node, "scale", None)
    return {
        "linear": vz.ScaleType.LINEAR,
        "log": vz.ScaleType.LOG,
        "rlog": vz.ScaleType.REVERSE_LOG,
    }.get(scale)


def _categories(choices: Any) -> List[str]:
    """One category string per candidate, guaranteed distinct.

    Non-primitive / oversized literals format as index/value pairs (the
    reference's scheme); duplicate primitive literals (distinct candidate
    subspaces with equal literal values) get the same index prefix — a
    silent first-match resolution would rebuild the wrong choice index.
    """
    literals = getattr(choices, "literal_values", None)
    n = len(choices.candidates)
    if not literals:
        return [str(i) for i in range(n)]
    out = []
    for index in range(n):
        value = literals[index]
        if not isinstance(value, (int, float, bool, str)):
            out.append(f"{index}/{value}")
            continue
        text = str(value)
        out.append(text if len(text) < 120 else f"{index}/{text[:100]}")
    if len(set(out)) != len(out):
        out = [f"{i}/{str(literals[i])[:100]}" for i in range(n)]
    return out


# ---------------------------------------------------------------------------
# DNASpec -> SearchSpace.
# ---------------------------------------------------------------------------


def to_search_space(dna_spec: Any) -> vz.SearchSpace:
    """Walks the DNASpec tree into a (possibly conditional) search space."""
    space = vz.SearchSpace()
    _add_space(space.root, dna_spec, prefix="")
    return space


def _add_space(selector, node: Any, prefix: str) -> None:
    for i, element in enumerate(getattr(node, "elements", ())):
        _add_decision_point(selector, element, prefix, i)


def _add_decision_point(selector, point: Any, prefix: str, index: int) -> None:
    key = prefix + _location_key(point, f"decision_{index}")
    if _is_choices(point):
        num_choices = int(getattr(point, "num_choices", 1) or 1)
        categories = _categories(point)
        # A k-subchoice Choices becomes k sibling categorical parameters
        # (reference `_make_decision_point`).
        for sub in range(num_choices):
            name = key if num_choices == 1 else f"{key}[{sub}]"
            param = selector.add_categorical_param(name, categories)
            for c, candidate in enumerate(point.candidates):
                if _space_is_constant(candidate):
                    continue
                # Conditional: the candidate's own decision points exist only
                # when this category is selected.
                child = param.select_values([categories[c]])
                _add_space(child, candidate, prefix=f"{name}/{c}/")
    elif _is_float(point):
        selector.add_float_param(
            key,
            float(point.min_value),
            float(point.max_value),
            scale_type=_scale_type(point) or vz.ScaleType.LINEAR,
        )
    else:
        # CustomDecisionPoint: free-form genome serialized as a string.
        selector.add_categorical_param(key, [_CUSTOM_PREFIX + "any"])


# ---------------------------------------------------------------------------
# DNA -> trial parameters and back.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DNASpecConverter:
    """Bidirectional DNA ⇄ trial-parameter mapping over one DNASpec."""

    dna_spec: Any

    def __post_init__(self):
        self.search_space = to_search_space(self.dna_spec)

    # -- DNA -> parameters --------------------------------------------------

    def dna_to_parameters(self, dna: Any) -> Dict[str, Any]:
        """Flattens a DNA tree into {parameter name: value}."""
        out: Dict[str, Any] = {}
        children = list(getattr(dna, "children", ()) or ())
        self._fill_space(self.dna_spec, children, "", out)
        return out

    def _fill_space(
        self, space: Any, dna_children: List[Any], prefix: str, out: Dict[str, Any]
    ) -> None:
        elements = list(getattr(space, "elements", ()))
        if len(dna_children) != len(elements):
            raise ValueError(
                f"DNA has {len(dna_children)} children for a space of "
                f"{len(elements)} decision points at {prefix!r}."
            )
        for i, (element, child) in enumerate(zip(elements, dna_children)):
            self._fill_point(element, child, prefix, i, out)

    def _fill_point(
        self, point: Any, dna: Any, prefix: str, index: int, out: Dict[str, Any]
    ) -> None:
        key = prefix + _location_key(point, f"decision_{index}")
        if _is_choices(point):
            num_choices = int(getattr(point, "num_choices", 1) or 1)
            if num_choices == 1:
                picks = [dna]
            else:
                picks = list(getattr(dna, "children", ()) or ())
                if len(picks) != num_choices:
                    raise ValueError(
                        f"{key}: expected {num_choices} subchoices, got "
                        f"{len(picks)}."
                    )
            for sub, pick in enumerate(picks):
                name = key if num_choices == 1 else f"{key}[{sub}]"
                choice = int(pick.value)
                out[name] = _categories(point)[choice]
                candidate = point.candidates[choice]
                if not _space_is_constant(candidate):
                    self._fill_space(
                        candidate,
                        list(getattr(pick, "children", ()) or ()),
                        f"{name}/{choice}/",
                        out,
                    )
        elif _is_float(point):
            out[key] = float(dna.value)
        else:
            out[key] = _CUSTOM_PREFIX + json.dumps(getattr(dna, "value", None))

    # -- parameters -> DNA values -------------------------------------------

    def parameters_to_dna_values(self, parameters: Dict[str, Any]) -> Any:
        """Rebuilds the nested DNA value tree from flat trial parameters.

        Returns a nested structure of plain values ([choice index | float |
        custom payload], children...) suitable for ``pg.DNA``-style
        construction: each node is ``(value, [children])``.
        """
        getter = {
            k: (v.value if hasattr(v, "value") else v)
            for k, v in dict(parameters).items()
        }
        return self._rebuild_space(self.dna_spec, "", getter)

    def _rebuild_space(self, space: Any, prefix: str, params) -> List[Tuple]:
        out = []
        for i, element in enumerate(getattr(space, "elements", ())):
            out.extend(self._rebuild_point(element, prefix, i, params))
        return out

    def _rebuild_point(self, point: Any, prefix: str, index: int, params) -> List[Tuple]:
        key = prefix + _location_key(point, f"decision_{index}")
        if _is_choices(point):
            num_choices = int(getattr(point, "num_choices", 1) or 1)
            picks = []
            for sub in range(num_choices):
                name = key if num_choices == 1 else f"{key}[{sub}]"
                if name not in params:
                    raise ValueError(f"Missing decision {name!r} in parameters.")
                value = str(params[name])
                categories = _categories(point)
                try:
                    choice = categories.index(value)
                except ValueError as e:
                    raise ValueError(
                        f"{name}: {value!r} is not a candidate literal."
                    ) from e
                candidate = point.candidates[choice]
                children = (
                    []
                    if _space_is_constant(candidate)
                    else self._rebuild_space(candidate, f"{name}/{choice}/", params)
                )
                picks.append((choice, children))
            if num_choices == 1:
                return picks
            return [(None, picks)]  # multi-choice container node
        if _is_float(point):
            if key not in params:
                raise ValueError(f"Missing decision {key!r} in parameters.")
            return [(float(params[key]), [])]
        raw = str(params.get(key, _CUSTOM_PREFIX + "null"))
        payload = raw[len(_CUSTOM_PREFIX):] if raw.startswith(_CUSTOM_PREFIX) else raw
        return [(json.loads(payload) if payload != "any" else None, [])]

    # -- trial plumbing -----------------------------------------------------

    def to_trial_suggestion(self, dna: Any) -> vz.TrialSuggestion:
        params = self.dna_to_parameters(dna)
        suggestion = vz.TrialSuggestion(parameters=params)
        suggestion.metadata.ns("pyglove")["dna_spec_values"] = json.dumps(
            params, default=str
        )
        return suggestion

    def to_dna_values(self, trial: vz.Trial) -> List[Tuple]:
        raw = trial.metadata.ns("pyglove").get("dna_spec_values")
        params = json.loads(raw) if raw is not None else trial.parameters
        return self.parameters_to_dna_values(params)
