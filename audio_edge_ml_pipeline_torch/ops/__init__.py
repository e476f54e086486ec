"""Batched DSP (torch ops) and the hand-written CUDA kernels behind it."""
