"""Runnable examples of the port (``python -m cermvs_torch.examples.<name>``)."""
