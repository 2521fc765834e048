"""Bucketing and the fused inversion's kernels (CUDA, with plain PyTorch versions)."""
