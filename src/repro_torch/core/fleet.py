"""Fleet-scale FL simulation: heterogeneous cohorts of hundreds of clients.

The paper validates MUDP on a 3-node star (2 clients, 1 server) and defers
"a larger Federated learning system" to future work.  This module is that
step: it turns the paper topology into a *scenario engine* —

* :class:`CohortSpec` — a named band of link/compute characteristics
  (``fiber`` / ``lte`` / ``congested-edge`` presets in
  :data:`COHORT_PRESETS`); every per-client quantity is a ``(lo, hi)``
  range.
* :class:`ClientProfile` — one client's concrete draw from its cohort:
  uplink/downlink rate, propagation delay, jitter, loss rate (Bernoulli or
  bursty Gilbert-Elliott), local train time, and aggregation weight.
* :func:`sample_profiles` — the seeded sampler.  It consumes only
  ``random.Random.random()`` (the one generator method with a documented
  cross-version stability guarantee) keyed by integers, so the same
  :class:`FleetConfig` produces **bit-identical** cohorts on every machine
  and Python version.
* :func:`build_fleet` — samples the cohorts and hands them to the
  topology named by ``FleetConfig.topology``
  (``repro_torch.core.topology``): ``star`` wires the paper's
  single-server hub (one asymmetric jittered lossy :class:`Link` pair per
  client), ``hier`` adds edge aggregators between the clients and the
  root, ``gossip`` goes serverless over a seeded peer graph.  All three
  return a system with the same ``run_round`` / ``run_rounds`` surface,
  dispatching through whatever transport the :class:`FLConfig` names.
* :class:`ConsensusObjective` — a synthetic quadratic objective (each
  client pulls the model toward a private target) whose global loss is
  analytically computable, giving benchmarks a deterministic
  rounds-to-target-loss metric without touching real data.

Partial participation, straggler cutoffs, and the scheduling mode are
*not* implemented here — they are first-class in
``repro_torch.core.rounds`` / ``repro_torch.core.scheduling``
(``participation_fraction``, ``round_deadline_ns``,
``mode="sync"|"async"``, ``buffer_k``); :class:`FleetConfig` simply
carries the knobs.
"""

from __future__ import annotations

import dataclasses
import hashlib
import random
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.core.channel import (BernoulliLoss, GilbertElliott, Link,
                                      LossModel)
from repro_torch.core.rounds import FLConfig
from repro_torch.core.simulator import Simulator

NS_PER_SEC = 1_000_000_000

Range = tuple[float, float]


# --------------------------------------------------------------------------
# Cohorts
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CohortSpec:
    """A named band of client characteristics; every field is drawn
    per-client, uniformly over its ``(lo, hi)`` range."""

    name: str
    up_rate_bps: Range              # uplink data rate
    down_up_ratio: float = 1.0      # downlink rate = uplink * ratio
    delay_ns: Range = (1_000_000, 5_000_000)
    jitter_frac: float = 0.0        # jitter_ns = jitter_frac * drawn delay
    loss_p: Range = (0.0, 0.0)
    bursty: bool = False            # Gilbert-Elliott instead of Bernoulli
    train_time_ns: Range = (500_000_000, 1_000_000_000)
    weight: Range = (0.5, 2.0)      # |D_k| proxy for weighted FedAvg
    # Async re-entry cadence: how long the device stays unavailable after
    # finishing an upload before it asks for new work (charging, other
    # apps, duty cycling).  Ignored by sync scheduling, where the round
    # barrier sets the cadence.  Drawn from its own RNG stream so adding
    # this field left every pre-existing profile draw bit-identical.
    cadence_ns: Range = (0, 0)


#: The presets the CI scenario matrix exercises. ``fiber`` is the
#: datacenter-adjacent best case, ``lte`` the PeerFL-style mobile mid-band,
#: ``congested-edge`` the FedComm-style constrained edge where protocol
#: rankings flip (slow, jittery, bursty loss -> stragglers and cutoffs).
COHORT_PRESETS: dict[str, CohortSpec] = {
    "fiber": CohortSpec(
        name="fiber",
        up_rate_bps=(200e6, 1000e6),
        down_up_ratio=1.0,
        delay_ns=(1_000_000, 5_000_000),          # 1-5 ms
        jitter_frac=0.1,
        loss_p=(0.0, 0.001),
        bursty=False,
        train_time_ns=(200_000_000, 500_000_000),  # 0.2-0.5 s
        cadence_ns=(50_000_000, 200_000_000),      # 50-200 ms
    ),
    "lte": CohortSpec(
        name="lte",
        up_rate_bps=(5e6, 50e6),
        down_up_ratio=4.0,                         # asymmetric cellular
        delay_ns=(20_000_000, 60_000_000),         # 20-60 ms
        jitter_frac=0.5,
        loss_p=(0.005, 0.03),
        bursty=False,
        train_time_ns=(500_000_000, 2_000_000_000),
        cadence_ns=(200_000_000, 1_000_000_000),   # 0.2-1 s
    ),
    "congested-edge": CohortSpec(
        name="congested-edge",
        up_rate_bps=(0.5e6, 4e6),
        down_up_ratio=2.0,
        delay_ns=(50_000_000, 200_000_000),        # 50-200 ms
        jitter_frac=1.0,
        loss_p=(0.05, 0.15),
        bursty=True,
        train_time_ns=(1_000_000_000, 5_000_000_000),
        cadence_ns=(500_000_000, 3_000_000_000),   # 0.5-3 s
    ),
}

#: Default cohort mix (fractions are normalized; PeerFL-style majority
#: mobile with a constrained tail).
DEFAULT_MIX: tuple[tuple[str, float], ...] = (
    ("fiber", 0.3), ("lte", 0.5), ("congested-edge", 0.2))


# --------------------------------------------------------------------------
# Profiles
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ClientProfile:
    """One client's concrete draw from its cohort."""

    addr: str
    cohort: str
    up_rate_bps: float
    down_rate_bps: float
    delay_ns: int
    jitter_ns: int
    loss_p: float
    bursty: bool
    train_time_ns: int
    weight: float
    seed: int                       # base seed for this client's link RNGs
    cadence_ns: int = 0             # async re-entry gap (sync ignores it)


@dataclasses.dataclass
class FleetConfig:
    """Declarative description of a heterogeneous fleet + round policy."""

    n_clients: int = 100
    cohort_mix: tuple[tuple[str, float], ...] = DEFAULT_MIX
    cohorts: Optional[dict[str, CohortSpec]] = None   # default COHORT_PRESETS
    seed: int = 0
    server_addr: str = "10.0.0.1"
    # Simulator engine: "batched" (the vectorized flight engine — the fleet
    # hot path), "per_packet" (the event-per-packet loop; the two are
    # bit-for-bit identical, so that choice is purely a speed knob), or
    # "flow" (the analytic tier — statistically equivalent to the packet
    # engines, bit-identical to the reference's flow engine, and the only
    # tier that takes 10k-100k-client fleets in minutes).
    engine: str = "batched"
    # Round policy, forwarded into FLConfig by build_fleet().
    participation_fraction: float = 1.0
    min_participants: int = 1
    round_deadline_ns: Optional[int] = None
    # Scheduling policy: "sync" (round barrier) or "async" (FedBuff-style
    # buffered aggregation over overlapping sessions).  Under async,
    # round_deadline_ns becomes the per-session watchdog and buffer_k is
    # the aggregation trigger.
    mode: str = "sync"
    buffer_k: int = 8
    # Batched wire plane (repro_torch.core.wire batch API): decode all arrived
    # uplink payloads in one stacked pass per aggregation and serve a
    # cached broadcast encode when the downlink pipeline is stateless.
    # Byte/bit-identical to the per-client loop, so this is purely a
    # throughput knob; False restores eager per-delivery decode.
    batch_wire: bool = True
    # Wire plane (repro_torch.core.wire): per-direction pipeline specs, forwarded
    # onto the TransportConfig by build_fleet().  None keeps whatever the
    # FLConfig's transport already says (usually the legacy codec).
    uplink: Optional[str] = None        # e.g. "delta|ef|topk(0.01)|int8(1024)"
    downlink: Optional[str] = None      # e.g. "int8(1024)"
    # Topology (repro_torch.core.topology): how the fleet is wired.  "star"
    # is the paper's single server; "hier" adds `cells` edge aggregators
    # between the clients and the root; "gossip" is serverless
    # peer-to-peer over a seeded ~`neighbors`-regular graph.
    topology: str = "star"
    cells: int = 4                      # hier: number of edge aggregators
    neighbors: int = 4                  # gossip: target peer degree
    edge_cohort: str = "fiber"          # hier: cohort band for edge<->root links
    cell_transport: Optional[str] = None   # hier: client<->edge transport kind
    # Per-hop wire pipeline specs, e.g. for hier:
    #   "client->edge: topk(0.01)|int8(1024); edge->root: delta"
    # Hop names are the topology's (topology_hops(name)); mutually
    # exclusive with the uplink/downlink shorthands above.
    hops: Optional[str] = None
    # What the clients train (repro_torch.core.client_compute model registry):
    # None keeps the caller-supplied train_fn_factory path (build_fleet);
    # "consensus" | "mlp" lets build_fleet_training() construct the model
    # and wire its per-client / batched training into the topology.
    model: Optional[str] = None
    model_args: Optional[dict] = None   # forwarded to the model factory
    # How local training executes (client_compute TrainBackend registry):
    # "python" = the per-client loop (bit-identical, digest-pinned);
    # "vmap" = one torch.func.vmap call per pending batch on the device;
    # "shard" = the vmap backend on the one card the port drives.
    train_backend: str = "python"
    # Adaptive transport control plane (repro_torch.core.control): the policy
    # consulted between transactions to renegotiate each client's wire
    # pipeline and FEC geometry from its telemetry.  "static" (default)
    # never renegotiates and is digest-pinned; "adaptive" walks the
    # loss-driven tier ladder.  Forwarded onto FLConfig by the topologies
    # (star and hier; gossip has no server core, so it ignores these).
    control: str = "static"
    control_args: Optional[dict] = None

    def __post_init__(self) -> None:
        # Topology parameters fail at construction, not deep inside
        # build_fleet.  Imported lazily: repro_torch.core.topology imports
        # this module for profiles/links, so a top-level import would be
        # circular (the _scheduler_registry idiom in repro_torch.core.server).
        from repro_torch.core.scheduling import SCHEDULERS
        from repro_torch.core.topology import (available_topologies,
                                               topology_hops)
        from repro_torch.core.transport import validate_transport_kind
        from repro_torch.core.wire import WireError, parse_hop_specs
        if self.n_clients < 1:
            raise ValueError("n_clients must be >= 1")
        if self.topology not in available_topologies():
            raise ValueError(f"unknown topology {self.topology!r}; one of "
                             f"{available_topologies()}")
        if self.mode not in SCHEDULERS:
            raise ValueError(f"unknown mode {self.mode!r}; one of "
                             f"{sorted(SCHEDULERS)}")
        if self.topology == "hier":
            if not 1 <= self.cells <= 250:
                raise ValueError("cells must be in [1, 250] (the edge "
                                 "address planes hold 250 aggregators)")
            if self.cells > self.n_clients:
                raise ValueError(f"cells ({self.cells}) cannot exceed "
                                 f"n_clients ({self.n_clients}): an edge "
                                 f"aggregator without a cell serves no one")
            if self.edge_cohort not in self.cohort_specs():
                raise ValueError(f"unknown edge_cohort {self.edge_cohort!r}; "
                                 f"available: {sorted(self.cohort_specs())}")
            if self.cell_transport is not None:
                validate_transport_kind(self.cell_transport)
        if self.topology == "gossip":
            if self.neighbors < 1:
                raise ValueError("gossip degree (neighbors) must be >= 1")
            if self.neighbors >= self.n_clients:
                raise ValueError(f"neighbors ({self.neighbors}) must be < "
                                 f"n_clients ({self.n_clients}): a client "
                                 f"cannot gossip with itself")
        if self.hops is not None:
            if self.uplink is not None or self.downlink is not None:
                raise ValueError("hops= and uplink=/downlink= are two "
                                 "spellings of the same thing; use one")
            try:
                parse_hop_specs(self.hops,
                                known_hops=topology_hops(self.topology))
            except WireError as e:
                raise ValueError(f"invalid hops spec: {e}") from None
        # Model / train-backend wiring (lazy import: client_compute pulls
        # in the model registry, heavy deps load only when asked for).
        from repro_torch.core.client_compute import (available_models,
                                                     available_train_backends)
        if self.model is not None and self.model not in available_models():
            raise ValueError(f"unknown model {self.model!r}; one of "
                             f"{available_models()}")
        if self.train_backend not in available_train_backends():
            raise ValueError(
                f"unknown train backend {self.train_backend!r}; one of "
                f"{available_train_backends()}")
        if self.model_args is not None and self.model is None:
            raise ValueError("model_args= without model=: name the model "
                             "the arguments configure")
        from repro_torch.core.control import available_policies
        if self.control not in available_policies():
            raise ValueError(f"unknown control policy {self.control!r}; "
                             f"one of {available_policies()}")
        if self.control_args is not None and self.control == "static":
            raise ValueError("control_args= with control='static': the "
                             "static policy takes no arguments; name the "
                             "policy they configure")

    def cohort_specs(self) -> dict[str, CohortSpec]:
        return self.cohorts if self.cohorts is not None else COHORT_PRESETS

    def cell_of(self, i: int) -> int:
        """Cell membership of client ``i`` under hier: round-robin, so
        every cell sees the same cohort mix in expectation."""
        return i % self.cells


def _client_addr(i: int) -> str:
    # 16-byte address budget (packets.py): "10.1.<hi>.<lo>" stays within it
    # for fleets up to 250 * 250 clients.
    return f"10.1.{i // 250}.{i % 250 + 1}"


def sample_profiles(cfg: FleetConfig) -> list[ClientProfile]:
    """Deterministically draw ``cfg.n_clients`` profiles from the mix.

    Only ``Random.random()`` is consumed, in a fixed order, keyed by
    integers — bit-identical across runs, platforms, and Python versions.
    """
    specs = cfg.cohort_specs()
    mix = list(cfg.cohort_mix)
    if not mix:
        raise ValueError("empty cohort_mix")
    for name, _ in mix:
        if name not in specs:
            raise ValueError(f"unknown cohort {name!r}; available: "
                             f"{sorted(specs)}")
    total_w = sum(max(0.0, w) for _, w in mix)
    if total_w <= 0:
        raise ValueError("cohort_mix weights must sum to > 0")
    cum, acc = [], 0.0
    for name, w in mix:
        acc += max(0.0, w) / total_w
        cum.append((name, acc))

    rng = random.Random(hash((int(cfg.seed), 0xF1EE7)))
    # Cadence draws come from their own stream: appending them to the main
    # stream would have shifted every draw after the first client and
    # silently re-rolled all pre-existing cohorts for a given seed.
    cadence_rng = random.Random(hash((int(cfg.seed), 0xCADE)))

    def u(lo: float, hi: float) -> float:
        return lo + (hi - lo) * rng.random()

    profiles: list[ClientProfile] = []
    for i in range(cfg.n_clients):
        r = rng.random()
        cohort = cum[-1][0]   # fallback guards float round-off on the last edge
        for name, edge in cum:
            if r < edge:
                cohort = name
                break
        spec = specs[cohort]
        up = u(*spec.up_rate_bps)
        delay = int(u(*spec.delay_ns))
        profiles.append(ClientProfile(
            addr=_client_addr(i),
            cohort=cohort,
            up_rate_bps=up,
            down_rate_bps=up * spec.down_up_ratio,
            delay_ns=delay,
            jitter_ns=int(spec.jitter_frac * delay),
            loss_p=u(*spec.loss_p),
            bursty=spec.bursty,
            train_time_ns=int(u(*spec.train_time_ns)),
            weight=u(*spec.weight),
            # Distinct per-client base seed; link RNGs offset from it.
            seed=int(cfg.seed) * 1_000_003 + i * 4,
            cadence_ns=int(spec.cadence_ns[0]
                           + (spec.cadence_ns[1] - spec.cadence_ns[0])
                           * cadence_rng.random()),
        ))
    return profiles


def profiles_digest(profiles: list[ClientProfile]) -> str:
    """Stable content hash of a cohort draw (replay checks, CI artifacts)."""
    h = hashlib.sha256()
    for p in profiles:
        h.update(repr(dataclasses.astuple(p)).encode())
    return h.hexdigest()


def _loss_model(p: ClientProfile, seed: int) -> LossModel:
    if p.bursty:
        # Bad-state loss an order of magnitude above the mean keeps the
        # drawn loss_p as the approximate stationary drop rate.
        return GilbertElliott(p_good_loss=p.loss_p / 4,
                              p_bad_loss=min(1.0, p.loss_p * 10),
                              p_bad=0.075, seed=seed)
    return BernoulliLoss(p=p.loss_p, seed=seed)


def links_for(p: ClientProfile) -> tuple[Link, Link]:
    """(uplink, downlink) for one profile, each with its own seeded loss
    and jitter streams."""
    up = Link(p.up_rate_bps, p.delay_ns, _loss_model(p, p.seed),
              jitter_ns=p.jitter_ns, jitter_seed=p.seed + 2)
    down = Link(p.down_rate_bps, p.delay_ns, _loss_model(p, p.seed + 1),
                jitter_ns=p.jitter_ns, jitter_seed=p.seed + 3)
    return up, down


TrainFnFactory = Callable[[int, ClientProfile], Callable]


def build_fleet(fleet: FleetConfig, global_params: Any,
                train_fn_factory: TrainFnFactory,
                fl_cfg: Optional[FLConfig] = None,
                ) -> tuple[Simulator, Any, list[ClientProfile]]:
    """Sample the cohorts and hand them to ``fleet.topology`` for wiring.

    ``train_fn_factory(i, profile)`` returns the i-th client's train_fn.
    ``fl_cfg`` carries transport/aggregation choices; the fleet's round
    policy (participation, deadline) overrides the corresponding FLConfig
    fields so one FleetConfig means one scenario regardless of transport.

    The returned ``system`` is a :class:`FederatedSystem` under ``star``,
    a ``HierSystem`` under ``hier``, a ``GossipSystem`` under ``gossip`` —
    all with the same ``run_round`` / ``run_rounds`` / ``global_params`` /
    ``history`` / ``on_round_end`` surface (``repro_torch.core.topology``).
    """
    from repro_torch.core.topology import make_topology
    profiles = sample_profiles(fleet)
    topo = make_topology(fleet.topology)
    sim, system = topo.build(fleet, profiles, global_params,
                             train_fn_factory, fl_cfg)
    return sim, system, profiles


@dataclasses.dataclass
class FleetBuild:
    """Everything :func:`build_fleet_training` wired together."""

    sim: Simulator
    system: Any                      # Federated/Hier/GossipSystem
    profiles: list[ClientProfile]
    model: Any                       # the ClientModel instance
    trainer: Optional[Any] = None    # BatchTrainer (None on "python")


def build_fleet_training(fleet: FleetConfig,
                         fl_cfg: Optional[FLConfig] = None) -> FleetBuild:
    """:func:`build_fleet` with the model and train backend wired in.

    The model named by ``fleet.model`` (default ``"consensus"``) supplies
    the global template and every client's training; ``fleet.train_backend
    != "python"`` additionally attaches a
    :class:`~repro_torch.core.client_compute.BatchTrainer` to every
    training site, so each round's local steps run as one vmapped batch
    on the device.  The ``"python"`` default attaches nothing — the
    topology runs the per-client path the replay digests pin.  An MLP
    model holds its data on the package's current device
    (:mod:`repro_torch.device`).
    """
    from repro_torch.core.client_compute import (BatchTrainer, attach_trainer,
                                                 make_model,
                                                 make_train_backend)
    model = make_model(fleet.model or "consensus", fleet.n_clients,
                       seed=fleet.seed, **(fleet.model_args or {}))
    sim, system, profiles = build_fleet(
        fleet, model.init_params(),
        lambda i, p: model.train_fn(i, p), fl_cfg)
    trainer = None
    if fleet.train_backend != "python":
        trainer = BatchTrainer(
            model, make_train_backend(fleet.train_backend),
            client_index={p.addr: i for i, p in enumerate(profiles)})
        attach_trainer(system, trainer)
    return FleetBuild(sim=sim, system=system, profiles=profiles,
                      model=model, trainer=trainer)


def cohort_counts(profiles: list[ClientProfile]) -> dict[str, int]:
    out: dict[str, int] = {}
    for p in profiles:
        out[p.cohort] = out.get(p.cohort, 0) + 1
    return out


# --------------------------------------------------------------------------
# Synthetic objective: deterministic rounds-to-target-loss
# --------------------------------------------------------------------------
class ConsensusObjective:
    """Quadratic consensus task: client ``k`` holds a private target
    ``c_k = c + heterogeneity * e_k`` (shared signal + client-specific
    noise) and local training moves the received model toward it,
    ``w' = w + lr * (c_k - w)``.  The reported loss is the distance to the
    consensus optimum ``w* = mean_k c_k``,

        L(w) = ||w - w*||^2 / n_params,

    which FedAvg under full reliable participation contracts geometrically
    (factor ``1 - lr`` per round, plus a small sampling-noise floor under
    partial participation), so "rounds to reach ``frac * L(w_0)``" is an
    analytically grounded convergence metric that lossy transports
    (zero-filled UDP gaps) and straggler cutoffs visibly hurt.
    """

    def __init__(self, n_clients: int, n_params: int, *, seed: int = 0,
                 lr: float = 0.5, heterogeneity: float = 0.1):
        rng = np.random.default_rng(seed)
        common = rng.standard_normal((1, n_params))
        noise = rng.standard_normal((n_clients, n_params))
        self.targets = (common + heterogeneity * noise).astype(np.float32)
        self.optimum = self.targets.mean(axis=0)
        self.lr = float(lr)

    def init_params(self) -> dict[str, np.ndarray]:
        return {"w": np.zeros((self.targets.shape[1],), np.float32)}

    def train_fn(self, i: int, profile: Optional[ClientProfile] = None
                 ) -> Callable:
        target = self.targets[i]

        def fn(params, round_idx, client):
            w = np.asarray(params["w"], np.float32)
            new = {"w": w + self.lr * (target - w)}
            return new, {"local_gap": float(np.mean((w - target) ** 2))}
        return fn

    def loss(self, params) -> float:
        w = np.asarray(params["w"], np.float32)
        return float(np.mean((w - self.optimum) ** 2))
