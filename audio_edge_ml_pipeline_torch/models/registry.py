"""Trainer registry (contract of the JAX package's ``models/registry.py``):
the port registers every trainer name the JAX package does."""

from __future__ import annotations

import logging
from typing import Type

from .base import BaseTrainer

logger = logging.getLogger(__name__)

_REGISTRY: dict[str, Type[BaseTrainer]] = {}


def register_model(cls: Type[BaseTrainer]) -> Type[BaseTrainer]:
    if not issubclass(cls, BaseTrainer):
        raise TypeError(f"@register_model expects a BaseTrainer subclass, got {cls!r}")
    if not hasattr(cls, "name") or not isinstance(cls.name, str):
        raise AttributeError(f"{cls!r} must define a 'name' class attribute (str)")
    if cls.name in _REGISTRY:
        if _REGISTRY[cls.name] is not cls:
            raise ValueError(f"Trainer name {cls.name!r} is already registered by {_REGISTRY[cls.name]!r}.")
        return cls
    _REGISTRY[cls.name] = cls
    logger.debug("Registered model trainer: %s (%s)", cls.name, cls.__name__)
    return cls


def get_model(name: str) -> Type[BaseTrainer]:
    if name not in _REGISTRY:
        available = ", ".join(sorted(_REGISTRY))
        raise KeyError(f"No trainer registered under {name!r}. Available: {available or '(none)'}")
    return _REGISTRY[name]


def list_models() -> list[str]:
    return sorted(_REGISTRY)
