"""Sequential conditional-tree traversal.

Copy of the JAX package's ``pyvizier/parameter_iterators.py``
(``SequentialParameterBuilder``): walks the conditional parameter tree,
yielding each *active* config for the caller to choose a value; chosen
values decide which children become active.
"""

from __future__ import annotations

from typing import Generator, Optional

from vizier_tpu_torch.pyvizier import parameter_config as pc
from vizier_tpu_torch.pyvizier import trial as trial_

_SENTINEL = object()


class SequentialParameterBuilder:
    """Generator protocol: iterate configs, send back chosen values.

    Example::

        walk = SequentialParameterBuilder(space)
        for config in walk:
            walk.choose_value(my_value_for(config))
        parameters = walk.parameters
    """

    def __init__(self, search_space: pc.SearchSpace):
        self._parameters = trial_.ParameterDict()
        self._gen = self._walk(search_space)
        self._current: Optional[pc.ParameterConfig] = None
        self._pending = _SENTINEL  # config produced by the last send()
        self._exhausted = False

    def _walk(
        self, space: pc.SearchSpace
    ) -> Generator[pc.ParameterConfig, pc.ParameterValueTypes, None]:
        def visit(config: pc.ParameterConfig):
            value = yield config
            self._parameters[config.name] = config.cast_value(value)
            for child in config.children:
                if any(
                    pc.parent_value_matches(value, pv)
                    for pv in child.matching_parent_values
                ):
                    yield from visit(child)

        for top in space.parameters:
            yield from visit(top)

    def __iter__(self) -> "SequentialParameterBuilder":
        return self

    def __next__(self) -> pc.ParameterConfig:
        if self._current is not None:
            raise RuntimeError("choose_value() must be called before advancing.")
        if self._exhausted:
            raise StopIteration
        if self._pending is not _SENTINEL:
            self._current = self._pending  # type: ignore[assignment]
            self._pending = _SENTINEL
        else:
            self._current = next(self._gen)
        return self._current

    def choose_value(self, value: pc.ParameterValueTypes) -> None:
        if self._current is None:
            raise RuntimeError("No pending parameter; call next() first.")
        self._current = None
        try:
            # send() delivers the value and advances to the next yield.
            self._pending = self._gen.send(value)
        except StopIteration:
            self._exhausted = True

    @property
    def parameters(self) -> trial_.ParameterDict:
        return self._parameters
