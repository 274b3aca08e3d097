"""Data sets for the port (numpy, bit-identical to the reference)."""

from repro_torch.data.pipeline import (TokenPipeline, federated_partitions,
                                       synthetic_batch)

__all__ = ["TokenPipeline", "federated_partitions", "synthetic_batch"]
