"""Command-line entry points of the port (``python -m
daspeech_torch.cli.generate``)."""
