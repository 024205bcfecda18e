"""Tensor ops of the port: geometry, correlation, voxel pooling, and the
hand-written CUDA kernels under ``ops/cuda``."""
