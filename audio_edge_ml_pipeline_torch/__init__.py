"""PyTorch + CUDA port of audio_edge_ml_pipeline_tpu for NVIDIA Hopper.

Keeps the JAX package's module names, registries, CLI flags and file
formats. Imports torch, never jax, and nothing of the JAX package. Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
