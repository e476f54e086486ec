"""Model layer: trainer registry, the ported deep trainers and the classical ones."""

from .base import BaseTrainer, TrainResult  # noqa: F401
from .registry import get_model, list_models, register_model  # noqa: F401

# Importing concrete modules triggers registration.
from . import classical as _classical  # noqa: E402,F401
from . import deep as _deep  # noqa: E402,F401
