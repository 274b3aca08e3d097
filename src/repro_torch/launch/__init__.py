"""Entry points of the LM side (``python -m repro_torch.launch.serve``)."""
