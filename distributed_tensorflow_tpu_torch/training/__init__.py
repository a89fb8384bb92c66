"""Training: only ``build_model_for`` is ported so far."""
