"""Host-side FL machinery of the port: wire plane, packets, simulator,
the Modified UDP transport, and the sync orchestrator.

The event calendar, transports, keyed RNG and wire bytes are numpy and
Python, as in the reference; arrays cross to the device only in client
training (:mod:`repro_torch.models`), the ``int8`` wire stage
(:mod:`repro_torch.core.wire`) and aggregation
(:mod:`repro_torch.core.aggregation`).  Import the submodules directly.
"""
