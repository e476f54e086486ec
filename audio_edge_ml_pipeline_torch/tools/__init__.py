"""Repository tools of the port, run as modules
(``python -m audio_edge_ml_pipeline_torch.tools.<tool>``)."""
