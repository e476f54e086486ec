"""Logging and device helpers."""

from .logging import setup_logging  # noqa: F401
