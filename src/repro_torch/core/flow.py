"""Flow-level simulator engine: analytic burst models instead of packets.

``Simulator(engine="flow")`` is the third engine tier, the port of the
reference's.  The per-packet and batched engines are bit-for-bit identical
to each other; the flow engine deliberately is not — it models each
transport transaction *analytically* (one Binomial loss draw per burst,
FIFO-cumsum serialization closed forms, expected jitter, expected-value
NACK/retransmission recursions with seeded stochastic rounding) and
schedules only a handful of calendar events per transaction.  Its
correctness claim against the packet engines is **statistical**
(``tests/statcheck.py`` gates flow against batched on round time, bytes on
wire, retransmission counts and rounds-to-target-loss).  Against the
reference's own flow engine it is exact: every draw below is host Python
on integer key material, so the same seed gives the same stats, hop bytes,
round records and parameters in both packages.

Every stochastic decision is a counter-based ``flow_uniform`` draw
(``repro_torch.core.channel``, stream tag ``FLOW_STREAM``) keyed by the
link's loss seed, the endpoint addresses, the transaction and a per-phase
counter — so a flow run is *deterministic and replayable per seed*,
exactly like the other engines, while drawing far fewer numbers.

Architecture mirrors the transport registry: this module owns the
framework — :class:`FlowCtx` (link occupancy, loss draws, stat ledgers),
:class:`FlowSender` / :class:`FlowTransport` (the ``Transport``-shaped
adapters), and :func:`register_flow_model` — while each transport module
(``mudp.py`` / ``udp.py`` / ``tcp.py`` / ``fec.py``) registers its own
analytic model at import time.  A transport with no registered flow model
is refused with the registered names, like an unknown transport kind.

Known approximations (documented, and what the statistical tolerances
absorb):

* per-packet jitter is replaced by its mean (``jitter_ns / 2``), so flow
  runs have slightly lower round-time variance on heavily jittered links;
* control packets (ACK/NACK/SYN/...) are modeled lossless, matching the
  default ``drop_control=False`` of the shipped loss models;
* recovery traffic (retransmissions, NACK volleys) is *accounted* at plan
  time and *delivered* at the analytically derived completion time, so
  mid-transaction snapshots of ``sim.stats`` may differ from the packet
  engines; totals at round boundaries agree.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Optional

import numpy as np

from repro_torch.core.channel import (FLOW_STREAM, flow_uniform,
                                      keyed_binomial, stochastic_round)
from repro_torch.core.packets import HEADER_BYTES, PacketKind
from repro_torch.core.simulator import (_DELIVERED_KEY, _DROPPED_KEY,
                                        _SENT_KEY, Node, Simulator)

# Phase tags keep the per-transaction draw streams decorrelated: the same
# (seed, txn, counter) key under a different phase is an independent draw.
PH_LOSS = 1       # Binomial loss count of a burst (counter = burst index)
PH_PICK = 2       # missing-sequence selection (counter = seq)
PH_LAST = 3       # last-packet-lost conditionals (counter = attempt)
PH_RETX = 4       # stochastic rounding of retransmission losses
PH_WINDOW = 5     # TCP per-window draws
PH_REORD = 6      # jitter-reordering conditionals (spurious NACK volleys)

_MASK64 = (1 << 64) - 1


# --------------------------------------------------------------------------
# Model registry (the transport-registry idiom)
# --------------------------------------------------------------------------
# transport name -> model(ctx) -> FlowOutcome.  Populated by the transport
# modules at import time (mudp.py, udp.py, tcp.py, fec.py) — the framework
# never imports them, so there is no import cycle.
FLOW_MODELS: dict[str, Callable] = {}


def register_flow_model(name: str, model: Callable, *,
                        overwrite: bool = False) -> None:
    """Register the analytic flow model for transport ``name``."""
    if not overwrite and name in FLOW_MODELS:
        raise ValueError(f"flow model {name!r} is already registered "
                         f"(pass overwrite=True to replace it)")
    FLOW_MODELS[name] = model


def available_flow_models() -> list[str]:
    return sorted(FLOW_MODELS)


@dataclasses.dataclass
class FlowOutcome:
    """What a transport's flow model hands back: when the sender finishes
    (and whether it failed), and the receiver-side delivery, if any."""

    end_ns: int
    completed: bool
    deliver_ns: Optional[int] = None
    packets: Optional[dict] = None       # seq -> Packet for the Delivery
    total: int = 0
    complete: bool = True                # Delivery.complete


# --------------------------------------------------------------------------
# Link occupancy + stat ledger
# --------------------------------------------------------------------------
class _Path:
    """One direction of a link pair, with the flow-engine closed forms:
    FIFO occupancy (``max(t, busy_until) + cumsum(serialization)``) and
    mean propagation."""

    __slots__ = ("sim", "src_addr", "dst_addr", "link", "eprop", "loss_p")

    def __init__(self, sim: Simulator, src_addr: str, dst_addr: str):
        link = sim._links.get((src_addr, dst_addr))
        if link is None:
            raise KeyError(f"no link {src_addr} -> {dst_addr}")
        self.sim = sim
        self.src_addr = src_addr
        self.dst_addr = dst_addr
        self.link = link
        self.eprop = link.expected_propagation_ns()
        self.loss_p = link.loss.stationary_loss_p()

    def occupy(self, t: int, sizes: list[int]) -> tuple[int, int]:
        """Serialize ``sizes`` back-to-back starting no earlier than ``t``;
        returns (first arrival, last arrival) under mean propagation."""
        link = self.link
        start = max(int(t), link._busy_until_ns)
        first = 0
        total = 0
        for i, s in enumerate(sizes):
            ser = link.serialization_ns(s)
            total += ser
            if i == 0:
                first = ser
        link._busy_until_ns = start + total
        return start + first + self.eprop, start + total + self.eprop


class FlowCtx:
    """Everything a transport's flow model needs: the paths, the keyed
    draws, and the stat ledger the completion event settles."""

    def __init__(self, sim: Simulator, src: Node, dst: Node,
                 packets: list, cfg, stats):
        self.sim = sim
        self.src = src
        self.dst = dst
        self.packets = packets
        self.cfg = cfg
        self.stats = stats               # repro_torch.core.mudp.TxnStats
        self.txn = packets[0].txn
        self.total = packets[0].total
        self.fwd = _Path(sim, src.addr, dst.addr)
        self.rev = _Path(sim, dst.addr, src.addr)
        self.p = self.fwd.loss_p         # payload loss on the forward path
        self.sizes = [p.size_bytes for p in packets]
        self.chunk = self.sizes[0]
        self.data_bytes = sum(self.sizes)
        # Replay-stable draw key: loss seed x endpoint addresses.  Sync
        # scheduling reuses one txn across a whole round, so the addresses
        # must decorrelate concurrent transactions (crc32: stable across
        # interpreters, unlike str hash).
        self.seed = ((getattr(self.fwd.link.loss, "seed", 0)
                      * 0x9E3779B1)
                     ^ zlib.crc32(src.addr.encode())
                     ^ (zlib.crc32(dst.addr.encode()) << 20)) & _MASK64
        # kind -> [sent, dropped]; settled into delivered counters by the
        # completion event.
        self._ledger: dict[PacketKind, list[int]] = {}
        self._bytes_sent = 0
        self._bytes_dropped = 0

    # -- keyed draws -------------------------------------------------------
    def uniform(self, phase: int, counter: int = 0, extra: int = 0) -> float:
        return flow_uniform(FLOW_STREAM, self.seed, self.txn, phase,
                            counter, extra)

    def binom(self, n: int, p: float, phase: int, counter: int = 0) -> int:
        return keyed_binomial(n, p, self.uniform(phase, counter))

    def sround(self, x: float, phase: int, counter: int = 0) -> int:
        return stochastic_round(x, self.uniform(phase, counter))

    def pick_missing(self, k: int) -> set[int]:
        """A uniformly random ``k``-subset of sequence numbers 1..total,
        keyed per-seq so the same transaction replays the same subset."""
        if k <= 0:
            return set()
        n = self.total
        if k >= n:
            return set(range(1, n + 1))
        u = np.fromiter((self.uniform(PH_PICK, s) for s in range(1, n + 1)),
                        np.float64, n)
        order = np.argpartition(u, k - 1)[:k]
        return {int(i) + 1 for i in order}

    # -- accounting --------------------------------------------------------
    def count(self, path: _Path, kind: PacketKind, n: int, nbytes: int,
              ndropped: int = 0, dropped_bytes: int = 0) -> None:
        """Account ``n`` sends (``ndropped`` of them lost) of ``kind`` over
        ``path`` — send-time counters exactly like ``Simulator.transmit``;
        delivered counters are settled by the completion event."""
        if n <= 0:
            return
        sim = self.sim
        stats = sim.stats
        stats["packets_sent"] += n
        stats["bytes_sent"] += nbytes
        k = _SENT_KEY[kind]
        stats[k] = stats.get(k, 0) + n
        if sim._hop_of:
            hop = sim._hop_of.get((path.src_addr, path.dst_addr))
            if hop is not None:
                sim.hop_bytes[hop] += nbytes
                sim.hop_packets[hop] += n
        if ndropped:
            stats["packets_dropped"] += ndropped
            k = _DROPPED_KEY[kind]
            stats[k] = stats.get(k, 0) + ndropped
        led = self._ledger.setdefault(kind, [0, 0])
        led[0] += n
        led[1] += ndropped
        self._bytes_sent += nbytes
        self._bytes_dropped += dropped_bytes

    def settle_delivered(self) -> None:
        """Fold the ledger's survivors into the delivered counters (called
        by the completion event)."""
        stats = self.sim.stats
        for kind, (sent, dropped) in self._ledger.items():
            c = sent - dropped
            if c <= 0:
                continue
            stats["packets_delivered"] += c
            k = _DELIVERED_KEY[kind]
            stats[k] = stats.get(k, 0) + c
        stats["bytes_delivered"] += self._bytes_sent - self._bytes_dropped


def reorder_prob(jitter_ns: int, gap_ns: int) -> float:
    """P(packet sent ``gap_ns`` earlier still arrives *after* a reference
    packet), both carrying iid ``U[0, jitter_ns)`` propagation jitter:
    ``P(j_early > gap + j_ref) = (J - g)^2 / (2 J^2)`` for ``g < J``."""
    if jitter_ns <= 0 or gap_ns >= jitter_ns:
        return 0.0
    x = (jitter_ns - gap_ns) / jitter_ns
    return 0.5 * x * x


def spurious_reorder_nacks(ctx, *, trailer_gap_ns: int | None = None,
                           phase_base: int = 0) -> int:
    """How many *surviving* interior packets the receiver NACKs anyway,
    because jitter reordered them behind the last packet.

    The packet receivers report gaps the moment the last packet arrives;
    with per-packet jitter comparable to the inter-packet serialization
    gap, in-flight interiors look like losses and draw an immediate NACK
    volley even though their originals land moments later.  The volley is
    pure overhead — duplicate retransmissions and NACK bytes, no timing
    consequence — but it dominates fleet-scale retransmission counts, so
    the flow engine reproduces it: one Bernoulli per interior with the
    exact pairwise reordering probability.

    ``trailer_gap_ns`` (the FEC case) conditions each draw on the parity
    trailer having beaten the last data packet — all three orderings share
    the last packet's jitter draw, so the joint probability
    ``(1 - gi - gp)^3 / 6`` (iid uniform jitter) is divided by the
    trailer-first probability the caller already gated on."""
    link = ctx.fwd.link
    jit = getattr(link, "jitter_ns", 0)
    n = ctx.total
    if jit <= 0 or n < 2:
        return 0
    ser = link.serialization_ns(ctx.chunk)
    if trailer_gap_ns is not None:
        q = reorder_prob(jit, trailer_gap_ns)
        if q <= 0.0:
            return 0
        gp = trailer_gap_ns / jit
    m = 0
    for i in range(1, n):
        if trailer_gap_ns is None:
            r = reorder_prob(jit, (n - i) * ser)
        else:
            x = 1.0 - (n - i) * ser / jit - gp
            r = min(1.0, x * x * x / 6.0 / q) if x > 0.0 else 0.0
        r *= 1.0 - ctx.p
        if r > 0.0 and ctx.uniform(PH_REORD, phase_base + i) < r:
            m += 1
    return m


# --------------------------------------------------------------------------
# The Transport-shaped adapters
# --------------------------------------------------------------------------
class FlowSender:
    """One transaction under the flow engine: runs the transport's analytic
    model at ``start()`` and schedules the (few) resulting events.  Exposes
    the same ``start()`` / ``stats`` / callback surface as the packet-level
    senders, so schedulers and topologies cannot tell the difference.

    ``cfg`` is captured per *transaction*, not per transport: the server
    passes each client's current effective TransportConfig
    (``ServerCore.transport_cfg_for``), so when the adaptive control plane
    renegotiates FEC geometry mid-run the analytic models see the new
    parameters on the very next transaction — same cadence as the packet
    engines, whose sender factories take the identical argument."""

    def __init__(self, model: Callable, sim: Simulator, src: Node,
                 dst: Node, packets: list, cfg, *,
                 on_complete: Optional[Callable] = None,
                 on_fail: Optional[Callable] = None):
        if not packets:
            raise ValueError("empty transaction")
        from repro_torch.core.mudp import TxnStats
        self._model = model
        self.sim, self.src, self.dst = sim, src, dst
        self.packets = packets
        self.cfg = cfg
        self.txn = packets[0].txn
        self.total = packets[0].total
        self.on_complete = on_complete
        self.on_fail = on_fail
        self.stats = TxnStats(txn=self.txn, total_packets=self.total)

    def start(self) -> None:
        from repro_torch.core.transport import Delivery
        sim = self.sim
        now = sim.now_ns
        self.stats.start_ns = now
        ctx = FlowCtx(sim, self.src, self.dst, self.packets, self.cfg,
                      self.stats)
        out = self._model(ctx)

        if out.packets is not None:
            delivery = Delivery(self.src.addr, self.txn, out.packets,
                                out.total, out.complete)
            deliver_at = max(now, int(out.deliver_ns))

            def _deliver() -> None:
                cb = getattr(sim, "_flow_deliver", {}).get(self.dst.addr)
                if cb is not None:
                    cb(delivery)
            sim.schedule(deliver_at - now, _deliver)

        end_at = max(now, int(out.end_ns))

        def _finish() -> None:
            st = self.stats
            st.end_ns = sim.now_ns
            st.completed = out.completed
            st.failed = not out.completed
            ctx.settle_delivered()
            cb = self.on_complete if out.completed else self.on_fail
            if cb is not None:
                cb(self)
        sim.schedule(end_at - now, _finish)


class _FlowReceiver:
    """Persistent receiver under the flow engine: a registry entry.  The
    senders drive delivery analytically, so the only receiver-side state is
    the ``on_deliver`` callback keyed by node address."""

    def __init__(self, sim: Simulator, addr: str):
        self.sim = sim
        self.addr = addr


class FlowTransport:
    """``Transport``-shaped wrapper that swaps a protocol's packet-level
    state machines for its registered analytic flow model.  Same ``name``,
    same ``caps`` — callers branch on capabilities and never notice."""

    def __init__(self, base):
        if base.name not in FLOW_MODELS:
            raise ValueError(
                f"transport {base.name!r} has no registered flow model; "
                f"flow-capable transports: {available_flow_models()}")
        self.base = base
        self.name = base.name
        self.caps = base.caps
        self._model = FLOW_MODELS[base.name]

    def create_sender(self, sim, src, dst, packets, cfg, *,
                      on_complete=None, on_fail=None):
        return FlowSender(self._model, sim, src, dst, packets, cfg,
                          on_complete=on_complete, on_fail=on_fail)

    def create_receiver(self, sim, node, cfg, on_deliver):
        registry = getattr(sim, "_flow_deliver", None)
        if registry is None:
            registry = sim._flow_deliver = {}
        registry[node.addr] = on_deliver
        return _FlowReceiver(sim, node.addr)


def maybe_flow(sim: Simulator, transport):
    """Wrap ``transport`` in its flow adapter when ``sim`` runs the flow
    engine; hand it back untouched otherwise.  The one hook every
    transport-dispatching layer (ServerCore, GossipSystem) calls."""
    if sim.engine == "flow":
        return FlowTransport(transport)
    return transport


# --------------------------------------------------------------------------
# Shared model building blocks (used by the transport modules)
# --------------------------------------------------------------------------
CONTROL_BYTES = HEADER_BYTES     # ACK/NACK/SYN/... are header-only packets
