"""Mesh layouts on the port: the logical-axis sharding rules
(:mod:`~repro_torch.distributed.sharding`) and the pod-axis FL aggregation
(:mod:`~repro_torch.distributed.fl_mesh`)."""
