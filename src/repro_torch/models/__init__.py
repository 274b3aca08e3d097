"""Models of the port (PyTorch modules and functions on the device)."""
