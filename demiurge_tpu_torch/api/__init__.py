"""Command-line entry point (``python -m demiurge_tpu_torch.api.cli``)."""
