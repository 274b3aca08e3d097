"""Data sets for the port (numpy, bit-identical to the reference)."""
