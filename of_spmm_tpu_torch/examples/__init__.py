"""Runnable examples of the port (``python -m of_spmm_tpu_torch.examples.<name>``)."""
