"""The GP model: params, kernels, posterior, label warping."""
