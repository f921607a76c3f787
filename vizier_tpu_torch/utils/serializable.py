"""Serialization contracts for algorithm-state checkpointing.

Parity with ``vizier/interfaces/serializable.py``: designers
checkpoint their state into study metadata; ``DecodeError`` signals that the
stored state is unusable and the caller must fall back to full trial replay.
"""

from __future__ import annotations

import abc

from vizier_tpu_torch.pyvizier import common


class DecodeError(Exception):
    """Stored state could not be decoded; fall back to replay."""


class Serializable(abc.ABC):
    """State fully captured by ``dump``; ``recover`` rebuilds from scratch."""

    @classmethod
    @abc.abstractmethod
    def recover(cls, metadata: common.Metadata) -> "Serializable":
        """Rebuilds the object purely from dumped metadata (raises DecodeError)."""

    @abc.abstractmethod
    def dump(self) -> common.Metadata:
        """Serializes full state to metadata."""


class PartiallySerializable(abc.ABC):
    """Object must be constructed normally, then ``load`` restores state."""

    @abc.abstractmethod
    def load(self, metadata: common.Metadata) -> None:
        """Restores state from dumped metadata (raises DecodeError)."""

    @abc.abstractmethod
    def dump(self) -> common.Metadata:
        """Serializes restorable state to metadata."""
