"""GRNND graph build and beam search in PyTorch, with hand-written CUDA kernels.

The port of the JAX package `repro` to PyTorch on an NVIDIA H100. It mirrors
`repro` module for module and imports nothing from it, nor JAX.
"""
