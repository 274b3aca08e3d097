"""Event-driven FL server core: per-client sessions over one Simulator.

The paper's Fig. 4 round is a *lockstep loop*: broadcast, wait for every
client, aggregate, repeat.  This module dissolves that loop into its event
structure so scheduling becomes a policy choice (``repro_torch.core.scheduling``)
instead of control flow:

* :class:`ClientSession` — one client's traversal of the
  broadcast -> train -> uplink -> ingest pipeline, with its own transaction
  numbers.  Sessions from different (virtual) rounds overlap freely in
  flight; every transport tolerates that because receivers key state by
  ``(sender addr, txn)`` (``TransportCaps.concurrent_txns``).
* :class:`ServerCore` — the mechanics shared by every scheduling policy:
  transport dispatch, packetizing, downlink/uplink senders, decode +
  zero-fill, the late-update staleness buffer, health tracking, and the
  aggregation math.  The core raises *events* (uplink ingested, session
  failed, downlink delivered) into whatever scheduler is bound to it; it
  never decides when a round starts or ends.

``repro_torch.core.rounds.FederatedSystem`` is the stable facade over
(core, scheduler); ``mode="sync"`` reproduces the reference's round loop
bit-for-bit (the pinned orchestrator digests), ``mode="async"`` runs
FedBuff-style overlapping rounds.

Configuration (:class:`FLConfig`), per-round accounting
(:class:`RoundResult`), the client object (:class:`FLClient`) and the
elastic health pool (:class:`ClientPool`) live here too — ``rounds``
re-exports them so existing imports keep working.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.core import aggregation as agg
from repro_torch.core.control import available_policies, make_policy
from repro_torch.core.packetizer import (Packetizer, flatten_to_vector, packetize,
                                   unflatten_from_vector)
from repro_torch.core.simulator import Simulator
from repro_torch.core.telemetry import Telemetry
from repro_torch.core.transport import (Delivery, Transport, TransportConfig,
                                  make_transport, validate_transport_kind)
from repro_torch.core.wire import (Pipeline, PipelineState, WireDecodeError,
                             decode_payload as wire_decode_payload,
                             decode_payload_batch as wire_decode_payload_batch,
                             legacy_pipeline, migrate_state, parse_pipeline)


def _scheduler_registry() -> dict:
    """The one source of truth for scheduling modes.

    Imported lazily: ``repro_torch.core.scheduling`` defines the policies and
    imports this module for the core types, so a top-level import here
    would be circular.  By construction time of any ``FLConfig`` the
    import graph is settled and the registry is populated.
    """
    from repro_torch.core.scheduling import SCHEDULERS
    return SCHEDULERS


# --------------------------------------------------------------------------
# Configuration (TransportConfig lives with the transport registry and is
# re-exported from repro_torch.core.rounds for backward compatibility)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class FLConfig:
    transport: TransportConfig = dataclasses.field(
        default_factory=TransportConfig)
    aggregation: str = "fedavg"          # pairwise (paper Eq.1) | fedavg | trimmed_mean
    # fedavg implementation: kernel (default: the CUDA fedavg kernel on the
    # package device, its plain PyTorch version on cpu) | numpy (the host
    # fold).  Both give the same bits, so the digests hold either way.
    aggregation_backend: str = "kernel"
    send_deltas: bool = False            # ship (trained - received) instead of weights
    error_feedback: bool = False         # residual compensation for lossy codecs
    broadcast_model: bool = True         # server->client downlink each round
    round_deadline_ns: Optional[int] = None
    server_lr: float = 1.0               # for delta aggregation
    staleness_discount: float = 0.5      # late update weight *= discount^age
    # discount**age underflows for large ages; the factor is clamped to
    # this floor so a straggler's update is discounted, never silently
    # dropped.  Clamp events surface as RoundResult.staleness_clamped.
    staleness_floor: float = 1e-6
    unhealthy_after_failures: int = 2
    readmit_after_rounds: int = 2
    # Partial participation (fleet-scale): each round samples
    # round(participation_fraction * |active|) clients, at least
    # min_participants, via a seeded Fisher-Yates draw keyed by
    # (participation_seed, round_idx) — deterministic across Python versions
    # because it only consumes Random.random().  Sync mode only: async
    # participation emerges from per-client cadence + health instead.
    participation_fraction: float = 1.0
    min_participants: int = 1
    participation_seed: int = 0
    # Scheduling policy: "sync" is the paper's round barrier (bit-compatible
    # with the reference loop); "async" is the FedBuff-style buffered
    # asynchronous server.
    mode: str = "sync"
    # Async only: aggregate whenever this many updates are buffered.
    buffer_k: int = 8
    # Async only: drop updates staler than this many aggregations (None =
    # keep everything, discounted).  Dropped counts surface in
    # RoundResult.metrics["stale_dropped"].
    max_staleness: Optional[int] = None
    # Batched wire-plane (repro_torch.core.wire batch API): uplink payloads are
    # decoded in one vectorized pass per aggregation instead of one call
    # per delivery, and a stateless downlink broadcast is encoded once per
    # model version and the bytes reused across clients.  Both paths are
    # bit-identical to the per-client loop (pinned by the orchestrator-
    # equivalence digests, which run with this default), so False exists
    # only to time the difference and to simplify debugging.
    batch_wire: bool = True
    # Adaptive transport control plane (repro_torch.core.control): the registered
    # policy consulted between transactions — sync round starts, async
    # session entries — to renegotiate each client's uplink/downlink
    # pipeline spec and FEC geometry from its telemetry.  "static" (the
    # default) skips the control step entirely and is pinned bit-identical
    # by the orchestrator-equivalence digests; "adaptive" is the built-in
    # loss-driven tier ladder.  control_args are the policy factory's
    # kwargs (e.g. {"hi": 0.05} for adaptive).
    control: str = "static"
    control_args: Optional[dict] = None

    def __post_init__(self) -> None:
        # Fail at construction time (with the registered names) rather than
        # deep inside receiver setup; also covers dataclasses.replace(...).
        validate_transport_kind(self.transport.kind)
        if self.mode not in _scheduler_registry():
            raise ValueError(f"unknown mode {self.mode!r}; one of "
                             f"{sorted(_scheduler_registry())}")
        if self.buffer_k < 1:
            raise ValueError("buffer_k must be >= 1")
        if self.aggregation_backend not in agg.FEDAVG_BACKENDS:
            raise ValueError(
                f"unknown aggregation_backend {self.aggregation_backend!r}; "
                f"one of {agg.FEDAVG_BACKENDS}")
        if (self.transport.uplink is not None
                and (self.send_deltas or self.error_feedback)):
            raise ValueError(
                "send_deltas/error_feedback are the legacy spellings of the "
                "'delta' and 'ef' pipeline stages; with transport.uplink "
                "set, put the stages in the spec instead "
                "(e.g. uplink='delta|ef|int8(1024)')")
        if self.control not in available_policies():
            raise ValueError(f"unknown control policy {self.control!r}; "
                             f"one of {available_policies()}")


@dataclasses.dataclass
class RoundResult:
    """One aggregation event.  Sync: one barrier round.  Async: one buffer
    flush (round_idx counts aggregations; roster is everyone who was in
    flight during the window)."""

    round_idx: int
    duration_ns: int
    arrived: list[str]
    failed: list[str]
    skipped_unhealthy: list[str]
    late_folded: int
    bytes_sent: int
    packets_sent: int
    packets_dropped: int
    retransmissions: int
    metrics: dict = dataclasses.field(default_factory=dict)
    roster: list[str] = dataclasses.field(default_factory=list)
    # Per-kind traffic split (from the simulator's per-PacketKind counters)
    # so benchmarks separate payload from protocol chatter.
    data_packets: int = 0
    nack_packets: int = 0
    parity_packets: int = 0
    # How many contributions had their staleness factor clamped to
    # FLConfig.staleness_floor (discount**age underflow guard).
    staleness_clamped: int = 0
    # Wire-plane counters for this window: payloads explicitly degraded to
    # zero-fill, and downlinks served from the broadcast-encode cache.
    decode_errors: int = 0
    bcast_cache_hits: int = 0
    # Per-client telemetry snapshots ({addr: repro_torch.core.telemetry.
    # ClientHealth}, sorted by addr) as of this window's end.
    client_health: dict = dataclasses.field(default_factory=dict)


# --------------------------------------------------------------------------
# Client
# --------------------------------------------------------------------------
class FLClient:
    """One federated client.

    ``train_fn(params, round_idx, client) -> (new_params, metrics)`` runs real
    local training; ``train_time_ns`` models how long that takes inside
    the simulation (heterogeneous values create stragglers); ``cadence_ns``
    is the async re-entry gap — how long the device stays unavailable after
    finishing an upload before it asks for fresh work (ignored by sync
    scheduling, where the round barrier sets the cadence).
    """

    def __init__(self, addr: str, train_fn: Callable, *,
                 train_time_ns: int = 1_000_000_000,
                 weight: float = 1.0,
                 cadence_ns: int = 0):
        self.addr = addr
        self.train_fn = train_fn
        self.train_time_ns = train_time_ns
        self.weight = weight
        self.cadence_ns = cadence_ns
        self.params: Any = None          # local copy of the global model
        # Wire state (delta references, error-feedback residuals) lives in
        # per-client PipelineStates owned by ServerCore, not here.
        self.metrics_history: list[dict] = []


class ClientPool:
    """Elastic membership with health tracking.  ``round_idx`` is the sync
    round counter or the async aggregation counter — benching and
    re-admission are measured in whichever unit the scheduler advances."""

    def __init__(self, clients: list[FLClient], *,
                 unhealthy_after: int = 2, readmit_after: int = 2):
        self.clients: dict[str, FLClient] = {c.addr: c for c in clients}
        self.failures: dict[str, int] = {c.addr: 0 for c in clients}
        self.benched_until: dict[str, int] = {}
        self.unhealthy_after = unhealthy_after
        self.readmit_after = readmit_after

    def active(self, round_idx: int) -> list[FLClient]:
        out = []
        for addr, c in self.clients.items():
            if self.benched_until.get(addr, -1) > round_idx:
                continue
            out.append(c)
        return out

    def is_active(self, addr: str, round_idx: int) -> bool:
        return (addr in self.clients
                and self.benched_until.get(addr, -1) <= round_idx)

    def benched(self, round_idx: int) -> list[str]:
        return [a for a, r in self.benched_until.items() if r > round_idx]

    def add(self, client: FLClient) -> None:
        """Elastic join: the client is active from the next roster."""
        self.clients[client.addr] = client
        self.failures[client.addr] = 0

    def remove(self, addr: str) -> None:
        self.clients.pop(addr, None)
        self.failures.pop(addr, None)
        self.benched_until.pop(addr, None)

    def record_failure(self, addr: str, round_idx: int) -> None:
        self.failures[addr] = self.failures.get(addr, 0) + 1
        if self.failures[addr] >= self.unhealthy_after:
            self.benched_until[addr] = round_idx + 1 + self.readmit_after
            self.failures[addr] = 0

    def record_success(self, addr: str) -> None:
        self.failures[addr] = 0


# --------------------------------------------------------------------------
# Sessions
# --------------------------------------------------------------------------
# Session lifecycle.  DOWNLINK -> TRAINING -> UPLINK -> ARRIVED is the happy
# path; FAILED (transport retry exhaustion) and TIMEOUT (async session
# watchdog) are terminal on the session but not on the client.
PENDING = "pending"
DOWNLINK = "downlink"
TRAINING = "training"
UPLINK = "uplink"
ARRIVED = "arrived"
FAILED = "failed"
TIMEOUT = "timeout"


@dataclasses.dataclass
class ClientSession:
    """One client's pass through broadcast -> train -> uplink -> ingest.

    ``round_idx`` is the *virtual* round this session belongs to (the loop
    index under sync scheduling; the client's own session count under
    async).  ``model_version`` is the server's aggregation counter at
    downlink time — async staleness is the version distance at ingest.
    Transaction numbering is session-scoped: the scheduler assigns
    ``txn_down``/``txn_up`` (sync reuses the round-derived pair so wire
    traffic is byte-identical to the pre-refactor loop; async draws a fresh
    pair per session so overlapping sessions never collide).
    """

    client: FLClient
    round_idx: int
    txn_down: int
    txn_up: int
    model_version: int = 0
    state: str = PENDING
    started_ns: int = 0

    @property
    def addr(self) -> str:
        return self.client.addr


class _PendingWire:
    """An uplink payload whose decode is deferred to aggregation time.

    With ``FLConfig.batch_wire`` the server hands schedulers one of these
    instead of a decoded vector; schedulers treat updates as opaque until
    :meth:`ServerCore.apply_aggregation`, which resolves every pending
    payload in one :func:`repro_torch.core.wire.decode_payload_batch` call.
    Decode is pure computation (no simulator events), so deferring it
    cannot move any event time or order.
    """

    __slots__ = ("data", "vec", "addr")

    def __init__(self, data: bytes, addr: Optional[str] = None):
        self.data: Optional[bytes] = data
        self.vec: Optional[np.ndarray] = None
        # Sender address, kept so a deferred decode failure can still be
        # attributed to the right client's telemetry.
        self.addr = addr

    def __repr__(self) -> str:
        state = "decoded" if self.vec is not None else \
            f"{len(self.data)}B pending"
        return f"_PendingWire({state})"


# --------------------------------------------------------------------------
# The server core
# --------------------------------------------------------------------------
class ServerCore:
    """Transport + packetizing + ingest + aggregation mechanics, policy-free.

    A scheduler (``repro_torch.core.scheduling``) is bound after construction and
    receives the events; the core never starts rounds, samples rosters, or
    decides when to aggregate.
    """

    def __init__(self, sim: Simulator, server_addr: str,
                 clients: list[FLClient], global_params: Any,
                 cfg: FLConfig):
        self.sim = sim
        self.cfg = cfg
        self.server_addr = server_addr
        self.server_node = sim.node(server_addr)
        self.pool = ClientPool(
            clients, unhealthy_after=cfg.unhealthy_after_failures,
            readmit_after=cfg.readmit_after_rounds)
        self.global_params = global_params

        # Wire plane: one pipeline per direction (repro_torch.core.wire).  A
        # spec on the TransportConfig means self-describing payloads for
        # that direction; otherwise the legacy codec runs headerless,
        # byte-identical to the pre-pipeline wire format (pinned by the
        # orchestrator-equivalence digests).  delta/ef state lives in
        # per-client PipelineStates here, not in the orchestration logic.
        t = cfg.transport
        self.uplink_pipeline: Pipeline = (
            parse_pipeline(t.uplink) if t.uplink is not None
            else legacy_pipeline(t.codec, t.codec_kwargs,
                                 send_deltas=cfg.send_deltas,
                                 error_feedback=cfg.error_feedback))
        self.downlink_pipeline: Pipeline = (
            parse_pipeline(t.downlink) if t.downlink is not None
            else legacy_pipeline(t.codec, t.codec_kwargs))
        self.packetizer = Packetizer(pipeline=self.downlink_pipeline,
                                     mtu=t.mtu)
        # Per-(client, direction) wire state, created lazily and persistent
        # across rounds (an EF residual must survive the round barrier).
        self._up_enc_state: dict[str, PipelineState] = {}
        self._down_enc_state: dict[str, PipelineState] = {}
        # Payloads that failed to decode and were explicitly degraded to a
        # zero vector (WireDecodeError — never a bare except).
        self.decode_errors = 0
        # Broadcast-encode cache accounting: how many downlinks reused the
        # per-model-version encoded bytes instead of re-encoding.
        self.bcast_cache_hits = 0

        # Adaptive control plane.  The telemetry plane is always on (pure
        # bookkeeping: no RNG, no events, no sim.stats — it cannot move a
        # digest); the controller is None under the default "static"
        # policy, which skips the whole control step.  Renegotiated
        # clients get per-addr overrides here; everyone else falls through
        # to the base pipelines/packetizer/config, so the default path is
        # bit-identical with or without this machinery.
        self.telemetry = Telemetry()
        self.controller = (None if cfg.control == "static"
                           else make_policy(cfg.control,
                                            **(cfg.control_args or {})))
        self.renegotiations: dict[str, int] = {}
        self._uplink_over: dict[str, Pipeline] = {}
        self._down_over: dict[str, tuple[Pipeline, Packetizer]] = {}
        self._cfg_over: dict[str, TransportConfig] = {}
        if (self.controller is not None
                and not self.uplink_pipeline.self_describing):
            raise ValueError(
                "adaptive control renegotiates the uplink in-band via the "
                "self-describing WireHeader; set transport.uplink to a "
                "pipeline spec (legacy codec mode cannot renegotiate)")

        self.history: list[RoundResult] = []
        self.on_round_end: Optional[Callable[[RoundResult, Any], None]] = None

        # Transport dispatch goes through the registry: the core has no
        # per-protocol branches, so new transports plug in unchanged.
        self.transport: Transport = make_transport(cfg.transport.kind)

        # Persistent receivers.
        self._server_rx = self.transport.create_receiver(
            sim, self.server_node, cfg.transport, self._on_server_delivery)
        self._client_rx: dict[str, object] = {}
        for c in clients:
            self.install_client_rx(c)

        self.scheduler = None            # bound by FederatedSystem
        # Session registries: uplink keyed by (client addr, txn_up) — the
        # server-side delivery identity — and downlink by (client addr,
        # txn_down) — the client-receiver identity.  Sync scheduling reuses
        # one (txn_down, txn_up) pair across a whole round, so values may be
        # shared; the addr component keeps lookups unambiguous.
        self._sessions_up: dict[tuple[str, int], ClientSession] = {}
        self._sessions_down: dict[tuple[str, int], ClientSession] = {}
        self._txn_counter = 0
        # Stragglers from closed sync rounds: (virtual round, addr, vec).
        # With batch_wire the third element may be a still-encoded
        # _PendingWire, resolved at the aggregation it folds into.
        self.late_buffer: list[tuple[int, str, Any]] = []
        # Monotonic retransmission counter (sender stats folded in on
        # completion or failure); schedulers snapshot + delta per window.
        self.retx_total = 0
        # Topology hook (repro_torch.core.topology): when set, a delivered
        # downlink triggers this callable instead of schedule_training —
        # the hierarchical topology uses it to run a whole edge-cell round
        # as one "training" step of the parent tier.  The override owes the
        # core an eventual uplink_update() on the session (or a session
        # failure), exactly like the default path.
        self.train_override: Optional[Callable[[ClientSession], None]] = None
        # Optional repro_torch.core.client_compute.BatchTrainer: when
        # attached, schedule_training submits each session's delivered
        # model immediately and collects the (batched) result when its
        # timer fires.  None = the per-client train_fn path, pinned by the
        # replay digests.
        self.batch_trainer: Optional[Any] = None

    def bind(self, scheduler) -> None:
        self.scheduler = scheduler

    # -- global model + cached size -------------------------------------------
    @property
    def global_params(self) -> Any:
        return self._global_params

    @global_params.setter
    def global_params(self, value: Any) -> None:
        # Invalidate the cached flat size: recomputed at most once per
        # assignment (i.e. per aggregation) instead of once per uplink
        # delivery — a full pytree flatten used to sit on the hot path.
        # The broadcast-encode cache rides the same invalidation: any model
        # update (aggregation, external assignment) drops the cached bytes,
        # so a stale broadcast can never be served.
        self._global_params = value
        self._n_params: Optional[int] = None
        self._bcast_cache: Optional[bytes] = None

    @property
    def n_params(self) -> int:
        if self._n_params is None:
            self._n_params = int(flatten_to_vector(self._global_params).size)
        return self._n_params

    # -- per-client effective wire plane --------------------------------------
    # Renegotiated clients (repro_torch.core.control) override the base pipeline
    # per address; everyone else falls through to the base objects, so the
    # static path allocates nothing and behaves bit-identically.
    def uplink_pipeline_for(self, addr: str) -> Pipeline:
        return self._uplink_over.get(addr, self.uplink_pipeline)

    def downlink_pipeline_for(self, addr: str) -> Pipeline:
        over = self._down_over.get(addr)
        return over[0] if over is not None else self.downlink_pipeline

    def packetizer_for(self, addr: str) -> Packetizer:
        over = self._down_over.get(addr)
        return over[1] if over is not None else self.packetizer

    def transport_cfg_for(self, addr: str) -> TransportConfig:
        return self._cfg_over.get(addr, self.cfg.transport)

    # -- per-client wire state -------------------------------------------------
    def wire_state(self, addr: str, *, direction: str) -> \
            Optional[PipelineState]:
        """The persistent PipelineState for one client's encode side of
        ``direction`` ("uplink": the client's encoder; "downlink": the
        server's per-client broadcast encoder).  None when that pipeline is
        stateless (nothing to persist).  Decode is stateless for every
        built-in stage."""
        pipeline, table = {
            "uplink": (self.uplink_pipeline_for(addr), self._up_enc_state),
            "downlink": (self.downlink_pipeline_for(addr),
                         self._down_enc_state),
        }[direction]
        if not pipeline.caps.stateful:
            return None
        state = table.get(addr)
        if state is None:
            state = table[addr] = pipeline.new_state()
        return state

    # -- adaptive control ------------------------------------------------------
    def apply_control(self, addr: str) -> bool:
        """Consult the bound control policy for one client (schedulers call
        this between transactions: sync at round start, async at session
        entry).  Returns True when something actually changed."""
        if self.controller is None:
            return False
        decision = self.controller.renegotiate(
            addr, self.telemetry.snapshot(addr),
            self.transport_cfg_for(addr))
        if decision is None:
            return False
        return self._apply_decision(addr, decision)

    def _apply_decision(self, addr: str, decision) -> bool:
        """Install one :class:`repro_torch.core.control.ControlDecision`.

        No-op decisions (every field already at its target) are filtered
        here, so policies may return their target config unconditionally
        and only real changes count as renegotiations.  The new config
        revalidates through ``dataclasses.replace`` (spec parse + dry-run
        probe), pipeline swaps migrate encoder state under the
        :func:`repro_torch.core.wire.migrate_state` rules (or reset it when the
        decision says so), and the aggregation domain is frozen: a policy
        that flips delta-ness would silently corrupt aggregation, so it is
        refused loudly.
        """
        cur = self.transport_cfg_for(addr)
        changes = {f: v for f in ("uplink", "downlink",
                                  "fec_block", "fec_parity")
                   if (v := getattr(decision, f)) is not None
                   and v != getattr(cur, f)}
        if not changes:
            return False
        new_cfg = dataclasses.replace(cur, **changes)
        if "uplink" in changes:
            new_pipe = parse_pipeline(new_cfg.uplink)
            if (new_pipe.caps.delta_domain
                    != self.uplink_pipeline.caps.delta_domain):
                raise ValueError(
                    f"control policy renegotiated {addr} to "
                    f"{new_cfg.uplink!r}, which flips the aggregation "
                    f"domain (delta vs weight) — policies must keep every "
                    f"tier in the configured domain")
            self._swap_state(addr, self._up_enc_state,
                             self.uplink_pipeline_for(addr), new_pipe,
                             reset=decision.reset_state)
            self._uplink_over[addr] = new_pipe
        if "downlink" in changes:
            if not self.downlink_pipeline.self_describing:
                raise ValueError(
                    "control policy renegotiated the downlink, but the "
                    "base downlink is a legacy (headerless) codec — the "
                    "client decodes those out-of-band and cannot follow "
                    "an in-band swap")
            new_down = parse_pipeline(new_cfg.downlink)
            self._swap_state(addr, self._down_enc_state,
                             self.downlink_pipeline_for(addr), new_down,
                             reset=decision.reset_state)
            self._down_over[addr] = (
                new_down, Packetizer(pipeline=new_down, mtu=new_cfg.mtu))
        self._cfg_over[addr] = new_cfg
        self.renegotiations[addr] = self.renegotiations.get(addr, 0) + 1
        return True

    def _swap_state(self, addr: str, table: dict, old_pipe: Pipeline,
                    new_pipe: Pipeline, *, reset: bool) -> None:
        """Re-key one client's encoder state for a renegotiated pipeline:
        migrate (EF residual / delta reference carry over) or reset."""
        if reset:
            state = new_pipe.new_state() if new_pipe.caps.stateful else None
        else:
            state = migrate_state(old_pipe, table.get(addr), new_pipe)
        if state is None:
            table.pop(addr, None)
        else:
            table[addr] = state

    # -- receiver plumbing ---------------------------------------------------
    def install_client_rx(self, client: FLClient) -> None:
        self._client_rx[client.addr] = self.transport.create_receiver(
            self.sim, self.sim.node(client.addr), self.cfg.transport,
            self._make_client_deliver(client))

    def remove_client(self, addr: str) -> None:
        """Elastic removal: drop pool membership AND the client's wire
        state — a later client at a recycled address must start with a
        clean delta reference / EF residual, not the dead client's."""
        self.pool.remove(addr)
        self._up_enc_state.pop(addr, None)
        self._down_enc_state.pop(addr, None)
        # Control-plane identity is per-address too: telemetry history,
        # renegotiated overrides and counters all die with the client.
        self.telemetry.forget(addr)
        self._uplink_over.pop(addr, None)
        self._down_over.pop(addr, None)
        self._cfg_over.pop(addr, None)
        self.renegotiations.pop(addr, None)

    # -- session management --------------------------------------------------
    def new_txn_pair(self) -> tuple[int, int]:
        """A fresh session-scoped (txn_down, txn_up) pair.  Starts above any
        round-scoped numbering so a mode switch can never collide."""
        sid = self._txn_counter
        self._txn_counter += 1
        return 2 * sid, 2 * sid + 1

    def reserve_txns(self, txn: int) -> None:
        """Keep session-scoped numbering above ``txn`` (sync rounds use
        round-derived pairs; async continues past them)."""
        self._txn_counter = max(self._txn_counter, txn // 2 + 1)

    def open_session(self, client: FLClient, round_idx: int,
                     txn_down: int, txn_up: int,
                     model_version: int = 0) -> ClientSession:
        s = ClientSession(client, round_idx, txn_down, txn_up,
                          model_version=model_version,
                          started_ns=self.sim.now_ns)
        self._sessions_down[(client.addr, txn_down)] = s
        self._sessions_up[(client.addr, txn_up)] = s
        self.reserve_txns(max(txn_down, txn_up))
        return s

    def drop_session(self, session: ClientSession) -> None:
        self._sessions_down.pop((session.addr, session.txn_down), None)
        self._sessions_up.pop((session.addr, session.txn_up), None)

    def clear_sessions(self) -> None:
        """Drop every session registration (sync: called at round start so
        stale traffic from a finished round can no longer match)."""
        self._sessions_up.clear()
        self._sessions_down.clear()

    def uplink_session(self, addr: str, txn: int) -> Optional[ClientSession]:
        return self._sessions_up.get((addr, txn))

    # -- downlink: server -> client -------------------------------------------
    def broadcast_payload(self) -> Optional[bytes]:
        """The current model's encoded broadcast bytes, cached per model
        version — or None when per-client encoding is required.

        A stateless downlink pipeline encodes the same model to the same
        bytes for every client (deterministic, pinned by wire_bench's
        determinism gate), so the N-client broadcast encodes **once** and
        reuses the bytes.  The cache is refused outright when the downlink
        pipeline is stateful (``PipelineCaps.stateful`` — e.g. ``ef|int8``
        compensates each client separately, so sharing bytes would corrupt
        per-client residuals) and invalidated on every ``global_params``
        assignment, so a stale model can never be served.
        """
        if not self.cfg.batch_wire or self.downlink_pipeline.caps.stateful:
            return None
        if self._bcast_cache is None:
            self._bcast_cache = self.packetizer.encode_bytes(
                self.global_params)
        else:
            self.bcast_cache_hits += 1
        return self._bcast_cache

    def begin_downlink(self, session: ClientSession) -> None:
        """Broadcast the current global model to the session's client
        through the downlink pipeline (per-client state: a stateful
        downlink, e.g. ``ef|int8``, compensates each client separately —
        such pipelines bypass the broadcast cache)."""
        session.state = DOWNLINK
        packetizer = self.packetizer_for(session.addr)
        # A renegotiated downlink encodes per client (its bytes differ
        # from the broadcast), so it bypasses the cache without charging a
        # spurious hit.
        data = (self.broadcast_payload()
                if session.addr not in self._down_over else None)
        if data is not None:
            packets = packetize(data, self.server_addr, session.txn_down,
                                packetizer.mtu)
        else:
            packets = packetizer.to_packets(
                self.global_params, self.server_addr, session.txn_down,
                state=self.wire_state(session.addr, direction="downlink"))
        self._make_sender(self.server_node,
                          self.sim.node(session.addr), packets,
                          session).start()

    def begin_local(self, session: ClientSession) -> None:
        """Skip the downlink (broadcast_model=False): hand the client the
        global model by reference and schedule training."""
        session.client.params = self.global_params
        self.begin_training_for(session)

    def _make_client_deliver(self, client: FLClient):
        def _cb(d: Delivery) -> None:
            session = self._sessions_down.get((client.addr, d.txn))
            if session is None or not self.scheduler.accept_downlink(session):
                return
            if d.complete:
                client.params = self.packetizer_for(
                    client.addr).from_packets(d.packets, self.global_params)
            else:
                # Best-effort downlink: the client trains on the zero-filled
                # model (Delivery.complete makes the gap explicit instead of
                # silently treating a partial broadcast as the full model).
                vec = self.decode_vec(d.reassemble(), direction="downlink",
                                      addr=client.addr)
                client.params = unflatten_from_vector(vec, self.global_params)
            self.begin_training_for(session)
        return _cb

    # -- local training ------------------------------------------------------
    def begin_training_for(self, session: ClientSession) -> None:
        """A delivered (or locally handed) model starts the session's
        training step: the default timer-driven ``train_fn`` call, or the
        topology's ``train_override`` (e.g. a nested edge-cell round)."""
        if self.train_override is not None:
            self.train_override(session)
        else:
            self.schedule_training(session)

    def schedule_training(self, session: ClientSession) -> None:
        session.state = TRAINING
        client = session.client
        if self.batch_trainer is not None:
            # The training input is fully known *now* (the model was just
            # delivered); only the result is deferred by the timer.  Submit
            # immediately so the trainer can run every pending session as
            # one vmapped batch, and collect at the timer — the result is
            # deterministic and per-client independent, so batching cannot
            # perturb any event time or order.
            trainer = self.batch_trainer
            key = id(session)
            trainer.submit(key, client.addr, client.params,
                           session.round_idx)

            def _batched_done() -> None:
                received, new_params, metrics = trainer.collect(key)
                client.metrics_history.append(metrics)
                client.params = new_params
                self.uplink_update(session, received, new_params)
            self.sim.schedule(client.train_time_ns, _batched_done)
            return

        def _train_done() -> None:
            received = client.params
            new_params, metrics = client.train_fn(
                received, session.round_idx, client)
            client.metrics_history.append(metrics)
            client.params = new_params
            self.uplink_update(session, received, new_params)
        self.sim.schedule(client.train_time_ns, _train_done)

    def uplink_update(self, session: ClientSession, received: Any,
                      new_params: Any) -> None:
        """Finish a training step: prime the uplink delta reference with
        the model the client trained *from* and ship the result.  Shared by
        the default timer path and topology train overrides."""
        pipeline = self.uplink_pipeline_for(session.addr)
        if pipeline.caps.delta_domain:
            # Prime the delta stage's reference: the model this client
            # just trained from.  The subtraction itself happens inside
            # the pipeline, not here.
            pipeline.set_reference(
                self.wire_state(session.addr, direction="uplink"),
                flatten_to_vector(received))
        self.send_update(session, new_params)

    # -- uplink: client -> server -------------------------------------------
    def send_update(self, session: ClientSession, payload_tree: Any) -> None:
        """Ship ``payload_tree`` through the uplink pipeline.  Delta
        shipping and error-feedback are pipeline stages; their state
        (reference model, residual) lives in this client's persistent
        PipelineState, not here."""
        session.state = UPLINK
        client = session.client
        vec = flatten_to_vector(payload_tree)
        data = self.uplink_pipeline_for(client.addr).encode(
            vec, self.wire_state(client.addr, direction="uplink"))
        packets = packetize(data, client.addr, session.txn_up,
                            self.packetizer.mtu)
        node = self.sim.node(client.addr)
        self._make_sender(node, self.server_node, packets, session).start()

    def _make_sender(self, src, dst, packets, session: ClientSession):
        addr = session.addr
        payload_bytes = sum(len(p.payload) for p in packets)
        n_packets = len(packets)

        def _observe(sender, completed: bool) -> None:
            # Telemetry feed: pure bookkeeping off the sender's TxnStats
            # (both packet engines fill the same shape; getattr keeps
            # third-party senders safe).  No events,
            # no RNG, no sim.stats: recording cannot move a digest.
            self._note_retx(sender)
            stats = getattr(sender, "stats", None)
            now = self.sim.now_ns
            start = getattr(stats, "start_ns", 0) if stats else 0
            end = getattr(stats, "end_ns", 0) if stats else 0
            duration = max(0, (end or now) - start) if start else 0
            self.telemetry.observe_txn(
                addr, now_ns=now, duration_ns=duration,
                data_sent=(getattr(stats, "data_sent", 0) or n_packets)
                if stats else n_packets,
                retransmissions=getattr(stats, "retransmissions", 0)
                if stats else 0,
                payload_bytes=payload_bytes, completed=completed)

        def _done(sender) -> None:
            _observe(sender, True)

        def _fail(sender) -> None:
            _observe(sender, False)
            self.scheduler.on_session_failed(session)
        return self.transport.create_sender(
            self.sim, src, dst, packets, self.transport_cfg_for(addr),
            on_complete=_done, on_fail=_fail)

    def _note_retx(self, sender) -> None:
        self.retx_total += getattr(sender.stats, "retransmissions", 0)

    # -- server-side delivery --------------------------------------------------
    def _on_server_delivery(self, d: Delivery) -> None:
        if not d.complete and not self.transport.caps.partial_delivery:
            return  # a reliable transport never hands over a partial payload
        if self.cfg.batch_wire:
            # Defer the decode: schedulers store updates opaquely until
            # aggregation, where every pending payload of the window
            # decodes in one vectorized batch (decode is pure computation,
            # so deferring it cannot move an event).  One caveat, by
            # design: a payload the scheduler *drops* before aggregating
            # (async max_staleness) is never decoded, so a malformed one
            # no longer bumps decode_errors — it contributes nothing
            # either way.
            vec: Any = _PendingWire(d.reassemble(), d.sender_addr)
        else:
            vec = self.decode_vec(d.reassemble(), addr=d.sender_addr)
        session = self.uplink_session(d.sender_addr, d.txn)
        self.scheduler.on_uplink(session, d.sender_addr, d.txn, vec)

    def decode_vec(self, data: bytes, *, direction: str = "uplink",
                   addr: Optional[str] = None) -> np.ndarray:
        """Decode a (possibly zero-filled) byte stream to a model-sized
        vector through the named direction's pipeline.

        Self-describing payloads decode from their own WireHeader (the
        receiver trusts the wire, not out-of-band config).  A payload that
        cannot be decoded raises :class:`WireDecodeError` inside the wire
        layer and is degraded **explicitly** here: zero vector +
        ``decode_errors`` counter — the same capability-driven zero-fill a
        partial best-effort delivery gets.  Any other exception is a bug
        and propagates."""
        pipeline = (self.uplink_pipeline if direction == "uplink"
                    else self.downlink_pipeline)
        n_expected = self.n_params
        try:
            if pipeline.self_describing:
                vec, negotiated = wire_decode_payload(data)
                if (negotiated.caps.delta_domain
                        != pipeline.caps.delta_domain):
                    # Aggregation semantics are server policy: a header
                    # whose delta-ness disagrees with the configured
                    # pipeline would be silently mis-aggregated (a delta
                    # read as full weights or vice versa), so it is
                    # refused like any other malformed payload.
                    raise WireDecodeError(
                        f"negotiated pipeline {negotiated.spec!r} is "
                        f"{'delta' if negotiated.caps.delta_domain else 'weight'}"
                        f"-domain but this server aggregates in the "
                        f"{'delta' if pipeline.caps.delta_domain else 'weight'}"
                        f" domain")
            else:
                vec = pipeline.decode(data)
        except WireDecodeError:
            self.decode_errors += 1
            if addr is not None:
                self.telemetry.observe_decode_error(addr,
                                                    now_ns=self.sim.now_ns)
            vec = np.zeros(n_expected, dtype=np.float32)
        if vec.size < n_expected:
            vec = np.concatenate(
                [vec, np.zeros(n_expected - vec.size, dtype=np.float32)])
        return vec[:n_expected]

    def decode_vec_batch(self, datas: list[bytes],
                         addrs: Optional[list] = None) -> np.ndarray:
        """Batched :meth:`decode_vec` over uplink payloads: one ``(N,
        n_params)`` float32 matrix, row i bit-identical to
        ``decode_vec(datas[i])`` — including the per-item degradation
        contract: a malformed payload zero-fills *its* row and bumps
        ``decode_errors``; it never poisons the rest of the batch
        (``decode_payload_batch`` isolates it via per-item fallback).
        ``addrs`` (parallel to ``datas``, entries may be None) attributes
        degradations to the right client's telemetry."""
        n_expected = self.n_params
        pipeline = self.uplink_pipeline

        def _degrade(i: int) -> None:
            self.decode_errors += 1
            if addrs is not None and addrs[i] is not None:
                self.telemetry.observe_decode_error(
                    addrs[i], now_ns=self.sim.now_ns)

        out = np.zeros((len(datas), n_expected), dtype=np.float32)
        if pipeline.self_describing:
            for i, (vec, negotiated, err) in enumerate(
                    wire_decode_payload_batch(datas)):
                if err is None and (negotiated.caps.delta_domain
                                    != pipeline.caps.delta_domain):
                    # Same policy refusal as decode_vec: a header whose
                    # delta-ness disagrees with the server's aggregation
                    # domain is degraded, not mis-aggregated.
                    vec = None
                if vec is None:
                    _degrade(i)
                    continue
                m = min(vec.size, n_expected)
                out[i, :m] = vec[:m]
            return out
        for i, data in enumerate(datas):
            try:
                vec = pipeline.decode(data)
            except WireDecodeError:
                _degrade(i)
                continue
            m = min(vec.size, n_expected)
            out[i, :m] = vec[:m]
        return out

    def _resolve_contribs(self, contribs: list) -> list:
        """Materialize any deferred (_PendingWire) updates in ``contribs``
        through one batched decode; pass decoded vectors through
        untouched.  The stacked matrix rows stream straight into the
        aggregation stack below, so a 256-client round does one vectorized
        wire pass instead of 256 pipeline walks."""
        pending = [v for v, _ in contribs
                   if isinstance(v, _PendingWire) and v.vec is None]
        if pending:
            mat = self.decode_vec_batch([p.data for p in pending],
                                        [p.addr for p in pending])
            for p, row in zip(pending, mat):
                p.vec = row
                p.data = None     # the bytes are dead weight once decoded
        return [(v.vec if isinstance(v, _PendingWire) else v, w)
                for v, w in contribs]

    # -- staleness -----------------------------------------------------------
    def staleness_factor(self, age: int) -> tuple[float, bool]:
        """``discount**age`` clamped to ``staleness_floor``: a stale update
        is discounted, never silently zeroed out.  Returns (factor,
        clamped?)."""
        factor = self.cfg.staleness_discount ** age
        if factor < self.cfg.staleness_floor:
            return self.cfg.staleness_floor, True
        return factor, False

    def fold_late_buffer(self, current_round: int,
                         contribs: list) -> tuple[int, int]:
        """Append the late-update buffer to ``contribs`` with
        staleness-discounted weights; returns (folded, clamped) counts."""
        folded = clamped = 0
        for upd_round, addr, vec in self.late_buffer:
            age = max(1, current_round - upd_round)
            w, was_clamped = self.staleness_factor(age)
            client = self.pool.clients.get(addr)
            contribs.append((vec, w * (client.weight if client else 1.0)))
            folded += 1
            clamped += was_clamped
        self.late_buffer = []
        return folded, clamped

    # -- aggregation -----------------------------------------------------------
    def apply_aggregation(self, contribs: list) -> None:
        """Fold ``[(flat vector, weight), ...]`` into the global model —
        the exact pre-refactor math, shared by every scheduling policy.
        Whether contributions are deltas is a *wire* property now: the
        uplink pipeline's ``delta_domain`` capability (the legacy
        ``send_deltas`` flag derives it)."""
        if not contribs:
            return
        # Batched wire-plane: updates arrive still-encoded (_PendingWire)
        # under batch_wire; decode them all in one vectorized pass BEFORE
        # the zero-weight filter so decode_errors accounting matches the
        # per-delivery mode for every payload that reached aggregation.
        contribs = self._resolve_contribs(contribs)
        # An empty-handed hierarchical edge forwards its unchanged model
        # with weight 0 (so the parent barrier still resolves); such
        # contributions carry no information and an all-zero-weight fold
        # would divide by zero, so they are dropped up front.
        contribs = [(v, w) for v, w in contribs if w > 0.0]
        if not contribs:
            return
        template = self.global_params
        if self.uplink_pipeline.caps.delta_domain:
            ws = np.asarray([w for _, w in contribs], dtype=np.float32)
            # sum(w * v) / sum(w): the fold from zero in arrival order is
            # the fedavg kernel's with the raw weights, and the division
            # stays on the host, so the mean keeps the reference's bits.
            mean_delta = agg.weighted_sum_stack(
                np.stack([v for v, _ in contribs]), ws,
                backend=self.cfg.aggregation_backend) / ws.sum()
            delta_tree = unflatten_from_vector(
                mean_delta.astype(np.float32), template)
            self.global_params = agg.apply_delta(
                template, delta_tree, self.cfg.server_lr)
            return

        if self.cfg.aggregation == "pairwise":
            # Paper Eq. 1: fold per arrival order.
            g = self.global_params
            for v, _ in contribs:
                g = agg.pairwise_average(g, unflatten_from_vector(v, template))
            self.global_params = g
        elif self.cfg.aggregation == "fedavg":
            # Contributions are already flat wire vectors: aggregate the
            # stack directly and unflatten once.  Bit-identical to the old
            # per-leaf tree fold (fedavg_stack's numpy path accumulates in
            # the same order/dtype), so the replay digests are unchanged.
            stack = np.stack([v for v, _ in contribs])
            vec = agg.fedavg_stack(stack, [w for _, w in contribs],
                                   backend=self.cfg.aggregation_backend)
            self.global_params = unflatten_from_vector(
                vec.astype(np.float32, copy=False), template)
        elif self.cfg.aggregation == "trimmed_mean":
            self.global_params = agg.trimmed_mean(
                [unflatten_from_vector(v, template) for v, _ in contribs])
        else:
            raise ValueError(f"unknown aggregation {self.cfg.aggregation}")

    # -- result plumbing -------------------------------------------------------
    def snapshot_stats(self) -> dict:
        return dict(self.sim.stats)

    def stats_delta(self, stats0: dict) -> dict:
        s1 = self.sim.stats
        return {
            "bytes_sent": s1["bytes_sent"] - stats0["bytes_sent"],
            "packets_sent": s1["packets_sent"] - stats0["packets_sent"],
            "packets_dropped": (s1["packets_dropped"]
                                - stats0["packets_dropped"]),
            "data_packets": s1.get("sent_data", 0) - stats0.get("sent_data", 0),
            "nack_packets": s1.get("sent_nack", 0) - stats0.get("sent_nack", 0),
            "parity_packets": (s1.get("sent_parity", 0)
                               - stats0.get("sent_parity", 0)),
        }

    def emit_result(self, result: RoundResult) -> RoundResult:
        self.history.append(result)
        if self.on_round_end is not None:
            self.on_round_end(result, self.global_params)
        return result
