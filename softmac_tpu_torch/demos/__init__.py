"""Demo drivers of the port (``python -m softmac_tpu_torch.demos.<name>``)."""
