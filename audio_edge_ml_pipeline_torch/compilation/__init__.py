"""Stage 7a/7b — compilation.

- to_tflite: the TFLite export CLI of stage 7a (fp32 / dynamic / int8 /
  float16, each evaluated by TensorFlow's interpreter, the best copied into a
  deploy bundle), on the bundle's forward written in TF ops (tf_forward);
  TensorFlow must be installed.
- generate_c_header: a .tflite flatbuffer as an alignas(8) C byte array for
  TFLite Micro firmware (the JAX package's, byte for byte).
- compile_xla: the latency bench of stage 7b, with the JAX module's name,
  flags and report keys; its "ahead of time" forward is a CUDA graph captured
  at a static batch, ``--tune-flags`` times eager, the graph and
  ``torch.compile``, and ``--tflite`` times a TFLite baseline.
"""
