"""Extractor registry: @register class decorator + name lookup.

Contract of the JAX package's ``features/registry.py`` (duplicate-name guard,
KeyError with available names on unknown lookup). Every name the JAX package
registers is ported.
"""

from __future__ import annotations

from typing import Type

_REGISTRY: dict[str, type] = {}

# extractors of the JAX package that are still to be ported: none
NOT_YET_PORTED: frozenset[str] = frozenset()


def register(cls: Type) -> Type:
    """Class decorator: register an extractor under its ``name`` attribute."""
    name = getattr(cls, "name", None)
    if not name:
        raise ValueError(f"{cls.__name__} must define a class-level 'name'.")
    if name in _REGISTRY and _REGISTRY[name] is not cls:
        raise ValueError(f"Duplicate extractor name: {name!r} ({cls.__name__} vs {_REGISTRY[name].__name__}).")
    _REGISTRY[name] = cls
    return cls


def get(name: str) -> type:
    """Look up an extractor class by registered name."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"Unknown extractor: {name!r}. Available: {sorted(_REGISTRY)}"
        ) from None


def list_extractors() -> list[str]:
    return sorted(_REGISTRY)
