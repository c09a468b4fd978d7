"""Runnable examples of the port (``python -m repro_torch.examples.<name>``),
twins of the reference package's ``examples/`` scripts."""
