"""Stage 7 — deployment codegen.

Counterpart of the JAX package's ``deploy/``: self-contained PlatformIO C
projects (C99 kernel library, mel frontend with librosa-contract parity,
weights in flash, ping-pong arena forward pass, PDM/I2S capture, serial
eval protocol) from the .npz model bundles and Stage-6 artifacts of either
package, byte-equal to the JAX package's for the same bundle, plus the
MicroPython/ulab pca_svm export. A host harness target lets the generated C
compile with gcc and be held against the port's pipeline. Host only.
"""

from .arena import ArenaEstimator, estimate_arena  # noqa: F401
from .codegen import ModelToC  # noqa: F401
