"""CPU tests of the benchmark (``python -m pytest benchmark/tests``); the
``cuda``-marked ones run a cell on a card and skip without one."""
