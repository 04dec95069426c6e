"""Device ops: quantile binning and the histogram kernels."""
