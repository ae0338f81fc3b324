"""Tensor ops of the port: spectral transforms, CFAR, compaction, kernels."""
