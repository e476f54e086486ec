"""Uniform logging configuration for every CLI: basicConfig(force=True) with
one shared format."""

from __future__ import annotations

import logging


def setup_logging(level: int = logging.INFO) -> None:
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname)-7s %(name)s - %(message)s",
        force=True,
    )
