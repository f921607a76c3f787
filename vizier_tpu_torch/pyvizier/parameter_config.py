"""Search-space parameter configuration.

Functional parity with the reference's ``ParameterConfig``/``SearchSpace``
(``vizier/_src/pyvizier/shared/parameter_config.py:168,1298``),
designed from scratch: typed parameters (DOUBLE/INTEGER/DISCRETE/CATEGORICAL,
plus CUSTOM), scale types (LINEAR/LOG/REVERSE_LOG/UNIFORM_DISCRETE), external
types (BOOLEAN/INTEGER/FLOAT round-tripping), conditional child parameters
keyed on matching parent values, fluent builders, and traversal/continuify
utilities used by the converters.

The conditional tree is represented directly: each ``ParameterConfig`` owns a
tuple of child configs, and every child records the parent values that
activate it. A parameter is *active* in a trial iff every ancestor's assigned
value matches the child's activation set — see ``SearchSpace.is_active_path``.
"""

from __future__ import annotations

import copy
import dataclasses
import enum
import math
import re
import warnings
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

ParameterValueTypes = Union[str, int, float, bool]


class ParameterType(enum.Enum):
    DOUBLE = "DOUBLE"
    INTEGER = "INTEGER"
    CATEGORICAL = "CATEGORICAL"
    DISCRETE = "DISCRETE"
    CUSTOM = "CUSTOM"

    def is_numeric(self) -> bool:
        return self in (ParameterType.DOUBLE, ParameterType.INTEGER, ParameterType.DISCRETE)

    def is_continuous(self) -> bool:
        return self == ParameterType.DOUBLE


class ScaleType(enum.Enum):
    """How a numeric parameter is mapped to [0, 1] for modeling."""

    LINEAR = "LINEAR"
    LOG = "LOG"
    REVERSE_LOG = "REVERSE_LOG"
    UNIFORM_DISCRETE = "UNIFORM_DISCRETE"

    def is_nonlinear(self) -> bool:
        return self in (ScaleType.LOG, ScaleType.REVERSE_LOG)


class ExternalType(enum.Enum):
    """The user-facing python type a parameter value converts back to."""

    INTERNAL = "INTERNAL"
    BOOLEAN = "BOOLEAN"
    INTEGER = "INTEGER"
    FLOAT = "FLOAT"


@dataclasses.dataclass(frozen=True)
class FidelityConfig:
    """Marks a parameter as a fidelity/resource axis (multi-fidelity BO)."""

    class Mode(enum.Enum):
        SEQUENTIAL = "SEQUENTIAL"
        NESTED = "NESTED"

    mode: Mode = Mode.SEQUENTIAL


def _is_close(a: float, b: float) -> bool:
    return math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-12)


@dataclasses.dataclass(frozen=True)
class ParameterConfig:
    """Immutable configuration of a single (possibly conditional) parameter.

    Use the ``factory`` classmethod (or ``SearchSpace`` fluent builders)
    rather than the raw constructor; the factory validates bounds/values and
    infers sensible scale types.
    """

    name: str
    type: ParameterType
    # For DOUBLE / INTEGER: inclusive (min, max).
    _bounds: Optional[Tuple[float, float]] = None
    # For DISCRETE (sorted floats) / CATEGORICAL (strings).
    _feasible_values: Tuple[ParameterValueTypes, ...] = ()
    scale_type: Optional[ScaleType] = None
    default_value: Optional[ParameterValueTypes] = None
    external_type: ExternalType = ExternalType.INTERNAL
    fidelity_config: Optional[FidelityConfig] = None
    # Conditional children; each child's matching_parent_values says which of
    # *this* config's values activate it.
    children: Tuple["ParameterConfig", ...] = ()
    matching_parent_values: Tuple[ParameterValueTypes, ...] = ()

    # --- construction -----------------------------------------------------

    @classmethod
    def factory(
        cls,
        name: str,
        *,
        bounds: Optional[Tuple[float, float]] = None,
        feasible_values: Optional[Sequence[ParameterValueTypes]] = None,
        scale_type: Optional[ScaleType] = None,
        default_value: Optional[ParameterValueTypes] = None,
        external_type: ExternalType = ExternalType.INTERNAL,
        fidelity_config: Optional[FidelityConfig] = None,
        children: Sequence[Tuple[Sequence[ParameterValueTypes], "ParameterConfig"]] = (),
    ) -> "ParameterConfig":
        if not name:
            raise ValueError("Parameter name must be non-empty.")
        if bounds is not None and feasible_values is not None:
            raise ValueError(
                f"{name}: at most one of bounds / feasible_values may be given "
                f"(bounds={bounds}, feasible_values={feasible_values})."
            )
        if bounds is None and feasible_values is None:
            # Neither ⇒ CUSTOM: an opaque parameter (reference
            # `parameter_config.py:255` factory semantics). Suggestion
            # algorithms and encoders REJECT spaces containing it (as in the
            # reference); it exists for externally-assigned values carried
            # verbatim through trials.
            if children:
                raise ValueError(f"{name}: CUSTOM parameters cannot have children.")
            return cls(
                name=name,
                type=ParameterType.CUSTOM,
                default_value=default_value,
                external_type=external_type,
                fidelity_config=fidelity_config,
            )
        if bounds is not None:
            lo, hi = bounds
            if isinstance(lo, bool) or isinstance(hi, bool):
                raise ValueError(f"{name}: bounds must be numeric, got bools.")
            if not (isinstance(lo, (int, float)) and isinstance(hi, (int, float))):
                raise ValueError(f"{name}: bounds must be numeric, got {bounds!r}.")
            if lo > hi:
                raise ValueError(f"{name}: min bound {lo} > max bound {hi}.")
            if isinstance(lo, int) and isinstance(hi, int):
                ptype = ParameterType.INTEGER
            else:
                ptype = ParameterType.DOUBLE
                lo, hi = float(lo), float(hi)
            cfg_bounds: Optional[Tuple[float, float]] = (lo, hi)
            values: Tuple[ParameterValueTypes, ...] = ()
        else:
            assert feasible_values is not None
            if not feasible_values:
                raise ValueError(f"{name}: feasible_values must be non-empty.")
            if len(set(feasible_values)) != len(feasible_values):
                raise ValueError(f"{name}: duplicate feasible values {feasible_values!r}.")
            if all(isinstance(v, str) for v in feasible_values):
                ptype = ParameterType.CATEGORICAL
                values = tuple(sorted(feasible_values))  # type: ignore[arg-type]
            elif all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in feasible_values):
                ptype = ParameterType.DISCRETE
                values = tuple(sorted(float(v) for v in feasible_values))
            else:
                raise ValueError(
                    f"{name}: feasible_values must be all-str (categorical) or "
                    f"all-numeric (discrete); got {feasible_values!r}."
                )
            cfg_bounds = None
        if scale_type in (ScaleType.LOG, ScaleType.REVERSE_LOG):
            if cfg_bounds is not None and cfg_bounds[0] <= 0:
                raise ValueError(
                    f"{name}: {scale_type.value} scale requires positive bounds, got {cfg_bounds}."
                )
            if ptype == ParameterType.DISCRETE and any(float(v) <= 0 for v in values):  # type: ignore[arg-type]
                raise ValueError(
                    f"{name}: {scale_type.value} scale requires positive values, got {values}."
                )
        child_tuple = tuple(
            dataclasses.replace(child, matching_parent_values=tuple(parent_values))
            for parent_values, child in children
        )
        config = cls(
            name=name,
            type=ptype,
            _bounds=cfg_bounds,
            _feasible_values=values,
            scale_type=scale_type,
            default_value=default_value,
            external_type=external_type,
            fidelity_config=fidelity_config,
            children=child_tuple,
        )
        if default_value is not None and not config.contains(default_value):
            raise ValueError(f"{name}: default {default_value!r} not in the feasible set.")
        for child in child_tuple:
            for pv in child.matching_parent_values:
                if not config.contains(pv):
                    raise ValueError(
                        f"{name}: child {child.name!r} activates on {pv!r}, "
                        "which is not a feasible parent value."
                    )
        return config

    # --- basic accessors --------------------------------------------------

    @property
    def bounds(self) -> Tuple[float, float]:
        """(min, max) for numeric types; DISCRETE returns (min, max) of values."""
        if self._bounds is not None:
            return self._bounds
        if self.type == ParameterType.DISCRETE:
            vals = [float(v) for v in self._feasible_values]  # type: ignore[arg-type]
            return (min(vals), max(vals))
        raise ValueError(f"{self.name}: bounds undefined for {self.type}.")

    @property
    def feasible_values(self) -> List[ParameterValueTypes]:
        if self._feasible_values:
            return list(self._feasible_values)
        if self.type == ParameterType.INTEGER:
            lo, hi = self._bounds  # type: ignore[misc]
            return list(range(int(lo), int(hi) + 1))
        raise ValueError(f"{self.name}: feasible_values undefined for {self.type}.")

    @property
    def num_feasible_values(self) -> float:
        if self.type == ParameterType.CUSTOM:
            return float("inf")
        if self.type == ParameterType.DOUBLE:
            lo, hi = self._bounds  # type: ignore[misc]
            return 1.0 if _is_close(lo, hi) else float("inf")
        if self.type == ParameterType.INTEGER:
            lo, hi = self._bounds  # type: ignore[misc]
            return int(hi) - int(lo) + 1
        return len(self._feasible_values)

    def contains(self, value: ParameterValueTypes) -> bool:
        """Whether ``value`` is feasible for this parameter."""
        if self.type == ParameterType.DOUBLE:
            if isinstance(value, bool) or not isinstance(value, (int, float)):
                return False
            lo, hi = self._bounds  # type: ignore[misc]
            return lo - 1e-12 <= float(value) <= hi + 1e-12
        if self.type == ParameterType.INTEGER:
            if isinstance(value, bool):
                return False
            if isinstance(value, float) and not value.is_integer():
                return False
            if not isinstance(value, (int, float)):
                return False
            lo, hi = self._bounds  # type: ignore[misc]
            return lo <= int(value) <= hi
        if self.type == ParameterType.DISCRETE:
            if isinstance(value, bool) or not isinstance(value, (int, float)):
                return False
            return any(_is_close(float(value), float(v)) for v in self._feasible_values)  # type: ignore[arg-type]
        if self.type == ParameterType.CATEGORICAL:
            if isinstance(value, bool) and self.external_type == ExternalType.BOOLEAN:
                value = "True" if value else "False"
            return isinstance(value, str) and value in self._feasible_values
        return True  # CUSTOM accepts anything.

    # --- transforms -------------------------------------------------------

    def continuify(self) -> "ParameterConfig":
        """Relaxes numeric/discrete parameters to DOUBLE over their range."""
        if self.children:
            raise ValueError(
                f"Cannot continuify parent parameter {self.name!r}: conditional "
                "children would be silently discarded."
            )
        if self.type == ParameterType.DOUBLE:
            return self
        if not self.type.is_numeric():
            raise ValueError(f"Cannot continuify {self.type} parameter {self.name}.")
        lo, hi = self.bounds
        scale = self.scale_type
        if scale == ScaleType.UNIFORM_DISCRETE:
            scale = ScaleType.LINEAR
        default = self.default_value
        if default is not None:
            default = float(default)  # type: ignore[arg-type]
        return ParameterConfig(
            name=self.name,
            type=ParameterType.DOUBLE,
            _bounds=(float(lo), float(hi)),
            scale_type=scale,
            default_value=default,
            external_type=self.external_type,
            matching_parent_values=self.matching_parent_values,
        )

    def traverse(self, show_children: bool = True) -> Iterator["ParameterConfig"]:
        """Pre-order DFS over this config and all descendants.

        ``show_children`` controls whether the yielded configs carry their
        ``children`` (reference ``traverse`` semantics); descendants are
        visited either way.
        """
        yield self if show_children else self.clone_without_children()
        for child in self.children:
            yield from child.traverse(show_children)

    def clone_without_children(self) -> "ParameterConfig":
        return dataclasses.replace(self, children=())

    @classmethod
    def merge(
        cls, one: "ParameterConfig", other: "ParameterConfig"
    ) -> "ParameterConfig":
        """Union of two childless configs of the same type.

        CATEGORICAL/DISCRETE merge to the union of feasible values;
        DOUBLE/INTEGER to the envelope of the bounds (reference
        ``parameter_config.py:540``). Used when combining search spaces
        from related studies (e.g. transfer-learning priors).
        """
        if one.children or other.children:
            raise ValueError(
                f"Cannot merge parameters with children: {one.name}, {other.name}."
            )
        if one.type != other.type:
            raise ValueError(
                f"Type conflict merging {one.name}: {one.type} vs {other.type}."
            )
        if one.scale_type != other.scale_type:
            warnings.warn(
                f"Scale type conflict merging {one.name}: keeping "
                f"{one.scale_type} over {other.scale_type}.",
                stacklevel=2,
            )
        # external_type survives only when unambiguous; defaults and fidelity
        # configs are dropped (reference merge rebuilds from values/bounds).
        external = (
            one.external_type
            if one.external_type == other.external_type
            else ExternalType.INTERNAL
        )
        if one.type in (ParameterType.CATEGORICAL, ParameterType.DISCRETE):
            values = sorted(set(one.feasible_values) | set(other.feasible_values))
            return cls.factory(
                name=one.name,
                feasible_values=values,
                scale_type=one.scale_type,
                external_type=external,
            )
        if one.type in (ParameterType.INTEGER, ParameterType.DOUBLE):
            lo = min(one.bounds[0], other.bounds[0])
            hi = max(one.bounds[1], other.bounds[1])
            if one.type == ParameterType.INTEGER:
                lo, hi = int(lo), int(hi)
            return cls.factory(
                name=one.name,
                bounds=(lo, hi),
                scale_type=one.scale_type,
                external_type=external,
            )
        raise ValueError(f"Cannot merge {one.type} parameter {one.name}.")

    def get_subspace_deepcopy(self, value: ParameterValueTypes) -> "SearchSpace":
        """The conditional subspace active when this parameter takes ``value``.

        Returns an empty space for DOUBLE (continuous parents cannot have
        children) and validates feasibility otherwise (reference
        ``parameter_config.py:696``).
        """
        if self.type == ParameterType.DOUBLE:
            return SearchSpace()
        # Validate the RAW value before casting: cast_value truncates (e.g.
        # int(2.7) == 2), which would silently select a different subspace.
        if not self.contains(value):
            raise InvalidParameterError(
                f"{self.name}: {value!r} is not a feasible value."
            )
        value = self.cast_value(value)
        space = SearchSpace()
        space.parameters = [
            copy.deepcopy(child)
            for child in self.children
            if any(
                parent_value_matches(value, pv)
                for pv in child.matching_parent_values
            )
        ]
        return space

    def add_children(
        self, new_children: Sequence[Tuple[Sequence[ParameterValueTypes], "ParameterConfig"]]
    ) -> "ParameterConfig":
        added = tuple(
            dataclasses.replace(c, matching_parent_values=tuple(pv)) for pv, c in new_children
        )
        for child in added:
            for pv in child.matching_parent_values:
                if not self.contains(pv):
                    raise ValueError(
                        f"{self.name}: child {child.name!r} activates on infeasible {pv!r}."
                    )
        return dataclasses.replace(self, children=self.children + added)

    def clear_external_type(self) -> "ParameterConfig":
        return dataclasses.replace(self, external_type=ExternalType.INTERNAL)

    # --- value helpers ----------------------------------------------------

    def cast_value(self, value: ParameterValueTypes) -> ParameterValueTypes:
        """Casts a raw value to this parameter's canonical python type."""
        if self.type == ParameterType.DOUBLE:
            return float(value)  # type: ignore[arg-type]
        if self.type == ParameterType.INTEGER:
            return int(value)  # type: ignore[arg-type]
        if self.type == ParameterType.DISCRETE:
            return float(value)  # type: ignore[arg-type]
        if self.type == ParameterType.CATEGORICAL:
            return str(value)
        return value

    def first_feasible_value(self) -> ParameterValueTypes:
        if self.default_value is not None:
            return self.default_value
        if self.type == ParameterType.CUSTOM:
            raise InvalidParameterError(
                f"{self.name}: CUSTOM parameter has no default value to seed with."
            )
        if self.type == ParameterType.DOUBLE:
            lo, hi = self.bounds
            return (lo + hi) / 2.0
        if self.type == ParameterType.INTEGER:
            # Arithmetic, not feasible_values[0]: wide integer ranges must not
            # materialize the whole range.
            return int(self._bounds[0])  # type: ignore[index]
        return self._feasible_values[0]


class InvalidParameterError(Exception):
    """A parameter value is infeasible for its config."""


@dataclasses.dataclass
class SearchSpaceSelector:
    """Fluent builder handle over a location in the (conditional) space.

    A selector addresses either the root of a ``SearchSpace`` or a parameter
    (by path of ``(name, activating values)`` pairs). ``add_*_param`` on a
    root selector appends a top-level parameter; on a parameter selector with
    selected values it appends a conditional child active for those values.
    """

    _space: "SearchSpace"
    # Path from root: each element is (param_name, parent_values or None).
    _path: Tuple[Tuple[str, Optional[Tuple[ParameterValueTypes, ...]]], ...] = ()

    # -- selection --

    def select_values(self, values: Sequence[ParameterValueTypes]) -> "SearchSpaceSelector":
        if not self._path:
            raise ValueError("select_values requires a selected parameter.")
        name, _ = self._path[-1]
        return SearchSpaceSelector(self._space, self._path[:-1] + ((name, tuple(values)),))

    def select(
        self, name: str, values: Optional[Sequence[ParameterValueTypes]] = None
    ) -> "SearchSpaceSelector":
        vals = tuple(values) if values is not None else None
        return SearchSpaceSelector(self._space, self._path + ((name, vals),))

    @property
    def parameter_name(self) -> str:
        if not self._path:
            raise ValueError("Root selector has no parameter name.")
        return self._path[-1][0]

    # -- builders --

    def _add(self, config: ParameterConfig) -> "SearchSpaceSelector":
        self._space._insert(self._path, config)
        return SearchSpaceSelector(self._space, self._path + ((config.name, None),))

    def add(self, config: ParameterConfig) -> "SearchSpaceSelector":
        """Adds a pre-built ParameterConfig at this location (top-level on a
        root selector; conditional child on a value-selected parameter)."""
        return self._add(config)

    @staticmethod
    def _indexed_name(name: str, index: Optional[int]) -> str:
        """``('rate', 0) -> 'rate[0]'`` multi-dimensional naming (reference
        ``_get_parameter_names_to_create``); ``index=None`` is a no-op."""
        if index is None:
            return name
        if index < 0:
            raise ValueError(f"{name}: index must be >= 0, got {index}.")
        return f"{name}[{index}]"

    @classmethod
    def parse_multi_dimensional_parameter_name(
        cls, name: str
    ) -> Optional[Tuple[str, int]]:
        """``'rate[10]' -> ('rate', 10)``; None when not multi-dimensional."""
        match = re.fullmatch(r"(?P<name>[^()]*)\[(?P<index>\d+)\]", name)
        if match is None:
            return None
        return match.group("name"), int(match.group("index"))

    def add_float_param(
        self,
        name: str,
        min_value: float,
        max_value: float,
        *,
        default_value: Optional[float] = None,
        scale_type: Optional[ScaleType] = ScaleType.LINEAR,
        index: Optional[int] = None,
    ) -> "SearchSpaceSelector":
        return self._add(
            ParameterConfig.factory(
                self._indexed_name(name, index),
                bounds=(float(min_value), float(max_value)),
                scale_type=scale_type,
                default_value=default_value,
            )
        )

    def add_int_param(
        self,
        name: str,
        min_value: int,
        max_value: int,
        *,
        default_value: Optional[int] = None,
        scale_type: Optional[ScaleType] = None,
        index: Optional[int] = None,
    ) -> "SearchSpaceSelector":
        if int(min_value) != min_value or int(max_value) != max_value:
            raise ValueError(f"{name}: integer bounds required, got {(min_value, max_value)}.")
        return self._add(
            ParameterConfig.factory(
                self._indexed_name(name, index),
                bounds=(int(min_value), int(max_value)),
                scale_type=scale_type,
                default_value=default_value,
            )
        )

    def add_discrete_param(
        self,
        name: str,
        feasible_values: Sequence[Union[int, float]],
        *,
        default_value: Optional[Union[int, float]] = None,
        scale_type: Optional[ScaleType] = ScaleType.LINEAR,
        auto_cast: bool = True,
        index: Optional[int] = None,
    ) -> "SearchSpaceSelector":
        external = ExternalType.INTERNAL
        if auto_cast and all(isinstance(v, int) or float(v).is_integer() for v in feasible_values):
            external = ExternalType.INTEGER
        return self._add(
            ParameterConfig.factory(
                self._indexed_name(name, index),
                feasible_values=list(feasible_values),
                scale_type=scale_type,
                default_value=default_value,
                external_type=external,
            )
        )

    def add_categorical_param(
        self,
        name: str,
        feasible_values: Sequence[str],
        *,
        default_value: Optional[str] = None,
        index: Optional[int] = None,
    ) -> "SearchSpaceSelector":
        return self._add(
            ParameterConfig.factory(
                self._indexed_name(name, index),
                feasible_values=list(feasible_values),
                default_value=default_value,
            )
        )

    def add_bool_param(
        self,
        name: str,
        *,
        default_value: Optional[bool] = None,
        index: Optional[int] = None,
    ) -> "SearchSpaceSelector":
        default = None if default_value is None else ("True" if default_value else "False")
        return self._add(
            ParameterConfig.factory(
                self._indexed_name(name, index),
                feasible_values=["False", "True"],
                default_value=default,
                external_type=ExternalType.BOOLEAN,
            )
        )

    def add_custom_param(
        self, name: str, *, default_value: Optional[ParameterValueTypes] = None
    ) -> "SearchSpaceSelector":
        """An opaque CUSTOM parameter: carried through trials, never modeled."""
        return self._add(
            ParameterConfig.factory(name, default_value=default_value)
        )


class SearchSpace:
    """An ordered collection of (possibly conditional) parameter configs."""

    def __init__(self, parameters: Sequence[ParameterConfig] = ()):
        self._parameters: List[ParameterConfig] = list(parameters)
        names = [p.name for p in self.all_parameters()]
        if len(set(names)) != len(names):
            raise ValueError(f"Duplicate parameter names in search space: {names}")

    # -- builders / selection --

    @property
    def root(self) -> SearchSpaceSelector:
        return SearchSpaceSelector(self)

    def select(self, name: str) -> SearchSpaceSelector:
        return SearchSpaceSelector(self).select(name)

    def select_root(self) -> SearchSpaceSelector:  # reference-compat alias
        return self.root

    # -- accessors --

    @property
    def parameters(self) -> List[ParameterConfig]:
        """Top-level parameter configs (children hang off these)."""
        return list(self._parameters)

    @parameters.setter
    def parameters(self, configs: Sequence[ParameterConfig]) -> None:
        self._parameters = list(configs)

    def all_parameters(self) -> List[ParameterConfig]:
        """All configs in pre-order, including conditional children."""
        out: List[ParameterConfig] = []
        for p in self._parameters:
            out.extend(p.traverse())
        return out

    def parameter_names(self, include_children: bool = True) -> List[str]:
        configs = self.all_parameters() if include_children else self._parameters
        return [p.name for p in configs]

    def get(self, name: str) -> ParameterConfig:
        for p in self.all_parameters():
            if p.name == name:
                return p
        raise KeyError(f"No parameter named {name!r} in search space.")

    def __contains__(self, name: str) -> bool:
        return any(p.name == name for p in self.all_parameters())

    def pop(self, name: str) -> ParameterConfig:
        """Removes and returns a top-level parameter."""
        for i, p in enumerate(self._parameters):
            if p.name == name:
                return self._parameters.pop(i)
        raise KeyError(f"No top-level parameter named {name!r}.")

    def num_parameters(self, of_type: Optional[ParameterType] = None) -> int:
        params = self.all_parameters()
        if of_type is None:
            return len(params)
        return sum(1 for p in params if p.type == of_type)

    @property
    def is_conditional(self) -> bool:
        return any(p.children for p in self._parameters)

    def is_empty(self) -> bool:
        return not self._parameters

    # -- semantics --

    def contains(self, parameters: Dict[str, Any]) -> bool:
        """Whether a {name: value} assignment is a feasible point.

        Values may be raw python values or objects with a ``.value`` attr.
        Every assigned name must exist and be feasible; every *active*
        parameter (parent chain matches) must be assigned; inactive
        parameters must not be assigned.
        """
        try:
            self.assert_contains(parameters)
            return True
        except InvalidParameterError:
            return False

    def assert_contains(self, parameters: Dict[str, Any]) -> None:
        def raw(v: Any) -> ParameterValueTypes:
            return v.value if hasattr(v, "value") else v

        assigned = {k: raw(v) for k, v in parameters.items()}
        known = {p.name for p in self.all_parameters()}
        for name in assigned:
            if name not in known:
                raise InvalidParameterError(f"Unknown parameter {name!r}.")

        def check(config: ParameterConfig, active: bool) -> None:
            if active:
                if config.name not in assigned:
                    raise InvalidParameterError(f"Missing active parameter {config.name!r}.")
                value = assigned[config.name]
                if not config.contains(value):
                    raise InvalidParameterError(
                        f"Value {value!r} infeasible for parameter {config.name!r}."
                    )
            elif config.name in assigned:
                raise InvalidParameterError(
                    f"Inactive conditional parameter {config.name!r} was assigned."
                )
            for child in config.children:
                child_active = active and config.name in assigned and any(
                    _parent_value_matches(assigned[config.name], pv)
                    for pv in child.matching_parent_values
                )
                check(child, child_active)

        for p in self._parameters:
            check(p, True)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, SearchSpace):
            return NotImplemented
        return self._parameters == other._parameters

    def __repr__(self) -> str:
        return f"SearchSpace({self._parameters!r})"

    def __deepcopy__(self, memo: Dict[int, Any]) -> "SearchSpace":
        return SearchSpace(copy.deepcopy(self._parameters, memo))

    # -- internal insertion used by selectors --

    def _insert(
        self,
        path: Tuple[Tuple[str, Optional[Tuple[ParameterValueTypes, ...]]], ...],
        config: ParameterConfig,
    ) -> None:
        if config.name in self:
            raise ValueError(f"Parameter {config.name!r} already exists.")
        if not path:
            self._parameters.append(config)
            return

        def insert_into(parent: ParameterConfig, remaining) -> ParameterConfig:
            if not remaining:
                raise AssertionError("empty path")
            name, values = remaining[0]
            if parent.name != name:
                raise KeyError(f"Expected {name!r}, found {parent.name!r}.")
            if len(remaining) == 1:
                if values is None:
                    raise ValueError(
                        f"Adding a conditional child under {name!r} requires "
                        "select_values(...) to pick activating parent values."
                    )
                return parent.add_children([(values, config)])
            new_children = []
            found = False
            for child in parent.children:
                if child.name == remaining[1][0]:
                    found = True
                    new_children.append(insert_into(child, remaining[1:]))
                else:
                    new_children.append(child)
            if not found:
                raise KeyError(f"No child {remaining[1][0]!r} under {parent.name!r}.")
            return dataclasses.replace(parent, children=tuple(new_children))

        for i, top in enumerate(self._parameters):
            if top.name == path[0][0]:
                self._parameters[i] = insert_into(top, path)
                return
        raise KeyError(f"No top-level parameter named {path[0][0]!r}.")


def parent_value_matches(
    assigned: ParameterValueTypes, parent_value: ParameterValueTypes
) -> bool:
    """Whether an assigned parent value activates a child keyed on parent_value.

    The single source of truth for conditional activation — used by
    ``SearchSpace.assert_contains``, the random/default samplers, and the
    service converters. Numerics compare with tolerance, strings exactly.
    """
    if isinstance(assigned, str) or isinstance(parent_value, str):
        return str(assigned) == str(parent_value)
    return _is_close(float(assigned), float(parent_value))


_parent_value_matches = parent_value_matches  # internal alias
