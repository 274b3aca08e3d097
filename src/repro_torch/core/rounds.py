"""The stable FL facade: :class:`FederatedSystem` = one core + one policy.

This module *binds*; everything a round does has a dedicated home:

* **mechanics** — ``repro_torch.core.server``: :class:`ServerCore`
  (transport dispatch, downlink/train/uplink legs, wire-pipeline
  encode/decode with explicit degradation, the late-update staleness
  buffer, health tracking, aggregation math) and the per-client
  :class:`ClientSession` state machine;
* **policy** — ``repro_torch.core.scheduling``: ``FLConfig.mode`` picks
  ``"sync"`` (the paper's Fig. 4 barrier, bit-compatible with the
  reference loop) or ``"async"`` (FedBuff-style overlapping rounds);
* **wire** — ``repro_torch.core.wire``: per-direction codec pipelines
  (``TransportConfig.uplink`` / ``downlink`` specs such as
  ``"delta|ef|int8(1024)"``), self-describing on the wire; the legacy
  ``TransportConfig.codec`` string still works byte-identically;
* **transports** — ``repro_torch.core.transport``: any name in
  ``available_transports()``, dispatched through the registry.

``FLConfig`` / ``RoundResult`` / ``FLClient`` / ``ClientPool`` are defined
in ``repro_torch.core.server`` and re-exported here, alongside
``TransportConfig``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from repro_torch import device as _device
from repro_torch.core.scheduling import make_scheduler, sample_participants  # noqa: F401
from repro_torch.core.server import (ClientPool, ClientSession, FLClient,  # noqa: F401
                               FLConfig, RoundResult, ServerCore)
from repro_torch.core.simulator import Simulator
from repro_torch.core.transport import TransportConfig  # noqa: F401  (re-export)

__all__ = [
    "ClientPool", "ClientSession", "FederatedSystem", "FLClient", "FLConfig",
    "RoundResult", "ServerCore", "TransportConfig",
]


class FederatedSystem:
    """Server + clients + transport over one Simulator.

    A thin facade binding a :class:`ServerCore` (mechanics) to the
    scheduler named by ``cfg.mode`` (policy).  Under ``sync`` each
    ``run_round`` call is one barrier round; under ``async`` each result is
    one buffered aggregation and ``run_rounds(n)`` performs up to ``n`` of
    them over continuously overlapping client sessions.  Rounds run their
    array work (aggregation, the ``int8`` wire kernels) on ``device``, the
    package default when None.
    """

    def __init__(self, sim: Simulator, server_addr: str,
                 clients: list[FLClient], global_params: Any,
                 cfg: Optional[FLConfig] = None, *,
                 device: _device.DeviceLike | None = None):
        self.cfg = cfg or FLConfig()
        self.device = device
        self.sim = sim
        self.server_addr = server_addr
        self.core = ServerCore(sim, server_addr, clients, global_params,
                               self.cfg)
        self.scheduler = make_scheduler(self.cfg.mode, self.core)

    # -- the stable surface ---------------------------------------------------
    def run_round(self, round_idx: Optional[int] = None) -> RoundResult:
        with _device.use_device(self.device):
            return self.scheduler.run_round(round_idx)

    def run_rounds(self, n: int) -> list[RoundResult]:
        with _device.use_device(self.device):
            return self.scheduler.run_rounds(n)

    def add_client(self, client: FLClient) -> None:
        """Elastic join (between rounds under sync; any time under async)."""
        self.core.pool.add(client)
        self.core.install_client_rx(client)
        self.scheduler.on_client_added(client)

    def remove_client(self, addr: str) -> None:
        self.core.remove_client(addr)

    # -- state owned by the core, surfaced here for compatibility ------------
    @property
    def global_params(self) -> Any:
        return self.core.global_params

    @global_params.setter
    def global_params(self, value: Any) -> None:
        self.core.global_params = value

    @property
    def pool(self) -> ClientPool:
        return self.core.pool

    @property
    def history(self) -> list[RoundResult]:
        return self.core.history

    @property
    def on_round_end(self) -> Optional[Callable[[RoundResult, Any], None]]:
        return self.core.on_round_end

    @on_round_end.setter
    def on_round_end(self,
                     cb: Optional[Callable[[RoundResult, Any], None]]) -> None:
        self.core.on_round_end = cb

    @property
    def transport(self):
        return self.core.transport

    @property
    def packetizer(self):
        return self.core.packetizer

    @property
    def server_node(self):
        return self.core.server_node
