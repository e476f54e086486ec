"""Stage 7a/7b — compilation.

- generate_c_header: a .tflite flatbuffer as an alignas(8) C byte array for
  TFLite Micro firmware (the JAX package's, byte for byte).
- compile_xla: the latency bench of stage 7b, with the JAX module's name,
  flags and report keys; its "ahead of time" forward is a CUDA graph captured
  at a static batch, and ``--tune-flags`` times eager, the graph and
  ``torch.compile``.

The JAX package's ``to_tflite`` (jax2tf export) is not ported yet, nor
compile_xla's ``--tflite`` baseline, which needs it.
"""
