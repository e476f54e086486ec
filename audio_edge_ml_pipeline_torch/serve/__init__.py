"""Serving: the edge device simulator, the ingestion HTTP API
(``api``), the ingestion-side mel preprocessor (``audio_processor``) and the
fleet dashboard (``dashboard``), each the counterpart of the JAX package's
module of the same name."""
