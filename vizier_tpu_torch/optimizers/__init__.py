"""ARD hyperparameter optimizer and the vectorized acquisition optimizer."""
