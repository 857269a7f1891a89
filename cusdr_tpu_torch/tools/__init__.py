"""Measurement tools of the port, run as
``python -m cusdr_tpu_torch.tools.<name>``."""
