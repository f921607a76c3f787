"""Test fixtures the port's runtime imports.

Only ``netchaos`` (the fleet's seeded network fault injection) is ported so
far.
"""
