"""Logging and device helpers."""
