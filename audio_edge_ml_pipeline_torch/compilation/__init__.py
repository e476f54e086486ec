"""Stage 7a/7b — compilation.

- generate_c_header: a .tflite flatbuffer as an alignas(8) C byte array for
  TFLite Micro firmware (the JAX package's, byte for byte).

The JAX package's ``to_tflite`` (jax2tf export) and ``compile_xla`` (the
XLA AOT latency bench) are not ported yet.
"""
