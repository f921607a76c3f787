"""Namespaced metadata store shared by studies and trials.

Functional parity with the reference's ``Namespace``/``Metadata``
(``vizier/_src/pyvizier/shared/common.py:90,225``), rebuilt
from scratch: a hierarchical namespace (tuple of string components, with a
``:``-separated escaped text encoding) mapping to per-namespace ``key ->
value`` stores, where values are ``str``, ``float``/``int``, ``bytes``, or
protobuf messages (anything exposing ``SerializeToString``).

Algorithm state checkpointing rides on this store (designers serialize their
state into a study-scoped namespace), so round-trip fidelity of the encoding
matters; see the property tests in ``tests/pyvizier/test_common.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Iterator, List, Mapping, MutableMapping, Optional, Tuple, Union

# Metadata values: plain scalars/bytes, or any protobuf-like object.
MetadataValue = Union[str, float, int, bytes, Any]

_ESCAPE = "\\"
_SEP = ":"


def _escape_component(component: str) -> str:
    return component.replace(_ESCAPE, _ESCAPE + _ESCAPE).replace(_SEP, _ESCAPE + _SEP)


def _split_encoded(encoded: str) -> List[str]:
    """Splits on unescaped separators and unescapes each component."""
    components: List[str] = []
    current: List[str] = []
    it = iter(encoded)
    for ch in it:
        if ch == _ESCAPE:
            nxt = next(it, None)
            if nxt is None:
                current.append(_ESCAPE)
            else:
                current.append(nxt)
        elif ch == _SEP:
            components.append("".join(current))
            current = []
        else:
            current.append(ch)
    components.append("".join(current))
    return components


class Namespace(tuple):
    """An immutable hierarchical namespace: a tuple of string components.

    The canonical text encoding prefixes each component with ``:`` and
    escapes literal ``:`` and ``\\`` inside components, so encoding is
    injective and ``Namespace.decode`` is its exact inverse. The root
    namespace encodes to the empty string.
    """

    __slots__ = ()

    def __new__(cls, components: Union[str, Iterable[str]] = ()) -> "Namespace":
        if isinstance(components, str):
            # A convenience: treat a plain string as a single component unless
            # it starts with ':' (then it is a canonical encoding).
            if components.startswith(_SEP):
                return cls.decode(components)
            components = (components,) if components else ()
        comps = tuple(components)
        for c in comps:
            if not isinstance(c, str):
                raise TypeError(f"Namespace components must be str, got {type(c)}")
        return super().__new__(cls, comps)

    @classmethod
    def decode(cls, encoded: str) -> "Namespace":
        """Inverse of ``encode``; also accepts non-canonical bare strings."""
        if not encoded:
            return cls(())
        if encoded.startswith(_SEP):
            encoded = encoded[1:]
        return super().__new__(cls, tuple(_split_encoded(encoded)))

    def encode(self) -> str:
        return "".join(_SEP + _escape_component(c) for c in self)

    def __add__(self, other: Iterable[str]) -> "Namespace":  # type: ignore[override]
        return Namespace(tuple(self) + tuple(Namespace(other)))

    def startswith(self, prefix: Iterable[str]) -> bool:
        p = tuple(Namespace(prefix))
        return tuple(self[: len(p)]) == p

    def ancestors(self) -> Iterator["Namespace"]:
        """Yields root, then each successively deeper prefix, ending with self."""
        for i in range(len(self) + 1):
            yield Namespace(self[:i])

    def __repr__(self) -> str:
        return f"Namespace({self.encode()!r})"


class _NamespaceView(MutableMapping[str, MetadataValue]):
    """A mutable dict-like view of one namespace inside a Metadata."""

    def __init__(self, metadata: "Metadata", ns: Namespace):
        self._metadata = metadata
        self._ns = ns

    def _store(self) -> Dict[str, MetadataValue]:
        return self._metadata._stores.setdefault(self._ns, {})

    def __getitem__(self, key: str) -> MetadataValue:
        return self._metadata._stores.get(self._ns, {})[key]

    def __setitem__(self, key: str, value: MetadataValue) -> None:
        self._store()[key] = value

    def __delitem__(self, key: str) -> None:
        del self._metadata._stores.get(self._ns, {})[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._metadata._stores.get(self._ns, {}))

    def __len__(self) -> int:
        return len(self._metadata._stores.get(self._ns, {}))

    def __contains__(self, key: object) -> bool:
        return key in self._metadata._stores.get(self._ns, {})

    def get(
        self, key: str, default: Any = None, *, cls: Optional[type] = None
    ) -> Any:
        """The value for ``key``, or ``default`` if absent or unconvertible.

        Bare ``get(key)`` returns whatever was stored (str, float, bytes,
        proto — unchanged). Passing ``cls`` requests typed access (reference
        ``Metadata.get`` contract): values already of type ``cls`` pass
        through, packed ``Any`` protos unpack into a ``cls()`` message, and
        anything else converts via ``cls(value)`` — e.g.
        ``get('restarts', cls=int)`` parses a stored ``"4"``.
        """
        store = self._metadata._stores.get(self._ns, {})
        if key not in store:
            return default
        try:
            return self._coerce(store[key], cls)
        except (TypeError, ValueError):
            return default

    @staticmethod
    def _coerce(value: MetadataValue, cls: Optional[type]) -> Any:
        if cls is None or isinstance(value, cls):
            return value
        if hasattr(value, "Unpack"):  # packed protobuf Any
            if not hasattr(cls, "DESCRIPTOR"):
                raise TypeError(f"Cannot unpack Any proto to non-proto {cls}.")
            message = cls()
            if not value.Unpack(message):
                raise TypeError(f"Cannot unpack Any proto to {cls}.")
            return message
        return cls(value)

    def get_or_error(self, key: str, *, cls: Optional[type] = None) -> Any:
        """Like ``[]``, with optional ``cls`` coercion; KeyError when absent
        (reference ``Metadata.get_or_error``)."""
        return self._coerce(self._metadata._stores.get(self._ns, {})[key], cls)

    def items_by_cls(self, *, cls: type) -> Iterator[Tuple[str, Any]]:
        """(key, value) pairs in this namespace whose value is a ``cls``."""
        for key, value in self._metadata._stores.get(self._ns, {}).items():
            if isinstance(value, cls):
                yield key, value

    def update(self, *args, **kwargs) -> None:
        self._store().update(*args, **kwargs)

    def ns(self, component: str) -> "_NamespaceView":
        return _NamespaceView(self._metadata, self._ns + (component,))

    @property
    def namespace(self) -> Namespace:
        return self._ns

    def current_ns(self) -> Namespace:  # reference-compat alias
        return self._ns


class Metadata(_NamespaceView):
    """Namespaced key→value store.

    ``Metadata()`` views the root namespace. ``m.ns('a').ns('b')['k'] = v``
    writes key ``k`` in namespace ``(a, b)``. ``abs_ns`` jumps to an absolute
    namespace. Iteration/getitem on a view only sees that namespace's keys.
    """

    # One shared root-namespace instance: Metadata() construction sits on
    # every trial proto conversion of the serving hot path, and Namespace
    # is immutable, so all roots can be the same tuple.
    _ROOT_NS = Namespace(())

    def __init__(
        self,
        *args,
        **kwargs,
    ):
        self._stores: Dict[Namespace, Dict[str, MetadataValue]] = {}
        # Inlined _NamespaceView.__init__(self, self, _ROOT_NS) — measured
        # on the suggest hot path (4 Metadata per served trial).
        self._metadata = self
        self._ns = Metadata._ROOT_NS
        if args or kwargs:
            self.update(*args, **kwargs)

    def abs_ns(self, ns: Union[Namespace, Iterable[str], None] = None) -> _NamespaceView:
        if ns is None:
            return _NamespaceView(self, Namespace(()))
        return _NamespaceView(self, Namespace(ns))

    def namespaces(self) -> List[Namespace]:
        """All namespaces that currently hold at least one key."""
        return [ns for ns, store in self._stores.items() if store]

    def subnamespaces(self, prefix: Union[Namespace, Iterable[str]]) -> List[Namespace]:
        p = Namespace(prefix)
        return [ns for ns in self.namespaces() if ns.startswith(p)]

    def attach(self, other: "Metadata") -> None:
        """Merges ``other`` into self (other's values win on key conflicts)."""
        for ns, store in other._stores.items():
            if store:
                self._stores.setdefault(ns, {}).update(store)

    def all_items(self) -> Iterator[Tuple[Namespace, str, MetadataValue]]:
        for ns, store in self._stores.items():
            for k, v in store.items():
                yield ns, k, v

    def get_proto(self, key: str, *, cls: type) -> Optional[Any]:
        """Returns the value for ``key`` parsed as proto message ``cls``.

        Accepts values stored either as a message instance or as serialized
        bytes. Returns None if the key is missing.
        """
        value = self.get(key)
        if value is None:
            return None
        if isinstance(value, cls):
            return value
        if isinstance(value, bytes):
            msg = cls()
            msg.ParseFromString(value)
            return msg
        raise TypeError(f"Metadata key {key!r} holds {type(value)}, not {cls}")

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Metadata):
            return NotImplemented
        mine = {ns: s for ns, s in self._stores.items() if s}
        theirs = {ns: s for ns, s in other._stores.items() if s}
        return mine == theirs

    def __ne__(self, other: object) -> bool:
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq

    def __repr__(self) -> str:
        parts = [f"{ns.encode() or '(root)'}:{dict(store)}" for ns, store in self._stores.items() if store]
        return f"Metadata({', '.join(parts)})"
