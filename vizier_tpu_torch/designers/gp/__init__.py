"""GP acquisition functions."""
