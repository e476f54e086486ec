"""Stage 6 — quantization / optimization benchmarking.

Counterpart of the JAX package's ``optimize/``: quantization is emulated
(fake-quant weights and inputs, real quantized artifacts on disk, real
accuracy and latency measurements on the card) and the stage writes the
same optimization_report.json and ``model_<mode>.npz`` artifacts. The
arithmetic of the artifacts is numpy float64 on the host, as in JAX, so both
packages write the same numbers; evaluation runs each view's ``predict`` on
the trainer's device.
"""
