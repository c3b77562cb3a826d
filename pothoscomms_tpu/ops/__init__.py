"""Functional cores — pure jittable JAX kernels for every block.

This is the compute path of the framework: every DSP kernel here
compiles through XLA for JAX's default device. It replaces the reference's xsimd SIMD kernel library (math/SIMD/*) and its
per-sample C++ loops with vectorized array programs.
"""
