"""Command-line tools of the port (``python -m yunet_tpu_torch.tools.<name>``)."""
