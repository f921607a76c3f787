"""Serialization contracts."""
