"""The port's sync orchestrator reproduces the reference's pinned digests.

The six replay scenarios (``repro_torch.replay``, ported from
``tests/test_orchestrator_equivalence.py``) run over every transport
(``mudp``, ``udp``, ``tcp``, ``mudp+fec``) under both packet engines, with
the fedavg kernel backend (its plain PyTorch version on the CPU) and with
the numpy fold.  All 96 runs must give the reference's pinned
``EXPECTED[(scenario, kind)]`` digest: round records, global model and
simulator stats bit for bit.
"""

from __future__ import annotations

import os
import sys

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch import replay  # noqa: E402
from repro_torch.core import transport as port_transport  # noqa: E402
from repro_torch.core.simulator import PACKET_ENGINES, Simulator  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
from test_orchestrator_equivalence import EXPECTED  # noqa: E402


@pytest.mark.parametrize("kind", ["mudp", "udp", "tcp", "mudp+fec"])
@pytest.mark.parametrize("backend", ["kernel", "numpy"])
@pytest.mark.parametrize("engine", PACKET_ENGINES)
@pytest.mark.parametrize("scenario", sorted(replay.SCENARIOS))
def test_digest_matches_reference_pin(scenario, engine, backend, kind):
    digest = replay.run_digest(scenario, kind, engine, device="cpu",
                               aggregation_backend=backend)
    assert digest == EXPECTED[(scenario, kind)]


def test_replay_constants_are_the_reference_pins():
    assert replay.EXPECTED == EXPECTED


def test_slice_registers_every_transport_and_wraps_each_in_flow():
    """Every transport is registered, the digests run the two packet
    engines, and the flow engine (once refused, ported since) is a third
    engine that wraps each registered transport in its analytic model."""
    from repro_torch.core.flow import FlowTransport, maybe_flow
    from repro_torch.core.simulator import ENGINES
    assert port_transport.available_transports() == ["mudp", "mudp+fec",
                                                     "tcp", "udp"]
    assert PACKET_ENGINES == ("per_packet", "batched")
    assert ENGINES == PACKET_ENGINES + ("flow",)
    sim = Simulator(engine="flow")
    for kind in port_transport.available_transports():
        wrapped = maybe_flow(sim, port_transport.make_transport(kind))
        assert isinstance(wrapped, FlowTransport) and wrapped.name == kind
