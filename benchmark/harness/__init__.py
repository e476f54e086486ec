"""The general parts of the harness: file lookup by name, the clip pool,
the trace reduction and the comparison with the reference."""
