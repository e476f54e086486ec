"""Model layer: trainer registry and the ported deep trainers."""

from .base import BaseTrainer, TrainResult  # noqa: F401
from .registry import get_model, list_models, register_model  # noqa: F401

# Importing concrete modules triggers registration.
from . import deep as _deep  # noqa: E402,F401
