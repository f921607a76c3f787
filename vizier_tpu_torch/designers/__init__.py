"""Designers of the port: the GP bandits and their quasi-random seeding."""
