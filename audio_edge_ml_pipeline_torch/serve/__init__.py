"""Serving: the edge device simulator."""
