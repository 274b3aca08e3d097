"""Pluggable transport API: one delivery contract for every protocol.

The paper's deliverable is a *comparison between transports* ("a comparison
between the traditional UDP protocol and the Modified UDP protocol will be
simulated").  Comparing N protocols under one FL harness requires the
orchestrator to be protocol-agnostic, so this module defines the contract
every transport implements and a string-keyed registry (the ``make_codec``
idiom) the orchestrator dispatches through:

* :class:`Delivery` — the single receiver-side callback payload.  Reliable
  transports deliver ``complete=True`` with every packet present; best-effort
  transports deliver whatever arrived with ``complete=False`` and the FL layer
  decides what to do with the gaps (:meth:`Delivery.reassemble` zero-fills).
* :class:`TransportCaps` — static capability flags so callers can branch on
  *what a transport guarantees* instead of on its name.
* :class:`Transport` — the abstract factory: ``create_sender`` /
  ``create_receiver`` over the discrete-event simulator.
* :func:`register_transport` / :func:`make_transport` /
  :func:`available_transports` — the registry.  Third-party transports
  register themselves and every benchmark/test that iterates
  ``available_transports()`` picks them up for free.

Sender contract: the object returned by ``create_sender`` exposes
``start()`` and ``stats`` (a :class:`repro_torch.core.mudp.TxnStats`); it calls
``on_complete(sender)`` on success and, if ``caps.supports_fail_cb``,
``on_fail(sender)`` after exhausting its retry budget.

Receiver contract: the object returned by ``create_receiver`` is persistent
(serves many senders/transactions) and invokes ``on_deliver(delivery)``
exactly once per transaction.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.core.mudp import MudpReceiver, MudpSender
from repro_torch.core.packets import Packet
from repro_torch.core.packetizer import DEFAULT_MTU, reassemble
from repro_torch.core.simulator import Node, Simulator
from repro_torch.core.tcp import TcpReceiver, TcpSender
from repro_torch.core.udp import UdpReceiver, UdpSender, reassemble_partial
from repro_torch.core.wire import (WireError, parse_pipeline,
                                   using_batch_backend)


# --------------------------------------------------------------------------
# The delivery contract
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Delivery:
    """What a receiver hands the application, for every transport.

    ``packets`` maps sequence number -> verified :class:`Packet`;
    ``total`` is the transaction's packet count ``Np`` (known even when some
    packets never arrived); ``complete`` is True iff all ``total`` packets are
    present — the unified form of the old reliable-full (3-arg) vs
    best-effort-partial (4-arg) callback shapes.
    """

    sender_addr: str
    txn: int
    packets: dict[int, Packet]
    total: int
    complete: bool

    def reassemble(self) -> bytes:
        """Byte stream for this delivery: exact when complete, zero-filled
        gaps otherwise (the UDP-baseline corruption the paper measures)."""
        if self.complete:
            return reassemble(self.packets)
        return reassemble_partial(self.packets, self.total)


@dataclasses.dataclass(frozen=True)
class TransportCaps:
    """Static guarantees a transport makes; callers branch on these, never on
    the transport's name."""

    reliable: bool = True            # delivers exactly the sent bytes or fails
    partial_delivery: bool = False   # may deliver with complete=False
    has_handshake: bool = False      # pays a connection setup round-trip
    supports_fail_cb: bool = True    # invokes on_fail after retry exhaustion
    # Multiple transactions may be in flight between one (src, dst) pair at
    # once: sender/receiver state is keyed by (addr, txn), never by address
    # alone.  Async (overlapping-round) scheduling requires this.  Opt-in
    # (default False) so a transport written before the flag existed is
    # refused by the async scheduler instead of silently corrupting
    # per-address state under overlapping sessions.
    concurrent_txns: bool = False


DeliverFn = Callable[[Delivery], None]


@dataclasses.dataclass
class TransportConfig:
    """Wire-level knobs shared by all transports (each reads what it needs).

    ``kind`` is validated against the registry at construction time, so a
    typo'd transport name fails at ``FLConfig(...)`` with the list of
    registered transports instead of deep inside receiver setup.  The same
    goes for the per-direction wire-pipeline specs.

    Wire plane: ``codec`` (+ ``codec_kwargs``) is the legacy single-stage
    form — headerless, byte-identical to the historical formats.
    ``uplink`` / ``downlink`` are composed pipeline specs
    (``repro_torch.core.wire``, e.g. ``"delta|ef|topk(0.01)|int8(1024)"``); when
    set, that direction ships **self-describing** payloads (a versioned
    WireHeader the receiver decodes from, no out-of-band config) and
    ``codec`` is ignored for it.  Each direction is independent — an
    unset one falls back to the legacy codec.
    """

    kind: str = "mudp"                  # any name in available_transports()
    codec: str = "raw"                  # raw | hex | int8 | topk
    codec_kwargs: dict = dataclasses.field(default_factory=dict)
    uplink: Optional[str] = None        # pipeline spec, client -> server
    downlink: Optional[str] = None      # pipeline spec, server -> client
    mtu: int = DEFAULT_MTU
    timeout_ns: int = 6_000_000_000     # sender/NACK timer (paper's timer)
    max_retries: int = 3                # the paper's Y
    udp_deadline_ns: int = 30_000_000_000
    fec_block: int = 8                  # mudp+fec: data packets per FEC block
    fec_parity: int = 1                 # mudp+fec: parity per block (0 = no
                                        # trailer; degrades to plain mudp)

    def __post_init__(self) -> None:
        validate_transport_kind(self.kind)
        if self.fec_block < 1:
            raise ValueError(f"fec_block must be >= 1, got {self.fec_block}")
        if self.fec_parity < 0:
            raise ValueError(
                f"fec_parity must be >= 0, got {self.fec_parity}")
        for direction, spec in (("uplink", self.uplink),
                                ("downlink", self.downlink)):
            if spec is None:
                continue
            try:
                pipeline = parse_pipeline(spec)
            except WireError as e:
                raise ValueError(
                    f"bad {direction} pipeline spec {spec!r}: {e}") from e
            if direction == "downlink" and pipeline.caps.delta_domain:
                raise ValueError(
                    "downlink pipeline cannot contain 'delta': the client "
                    "needs the full model, not a server-side difference")
            # Dry-run probe: a spec can parse yet be incoherent between
            # stages (e.g. "int8(1024)|raw" — raw upcasts the int8 body,
            # so every decode fails; "hex|int8" feeds int8 non-floats).
            # Catching that here costs one 8-element round-trip instead of
            # a run that silently zero-degrades every payload.  The probe
            # runs on the host codec, so building a config needs no device.
            probe = np.linspace(-1.0, 1.0, 8, dtype=np.float32)
            state = pipeline.new_state()
            pipeline.set_reference(state, np.zeros(8, dtype=np.float32))
            try:
                with using_batch_backend("numpy"):
                    pipeline.decode(pipeline.encode(probe, state),
                                    pipeline.new_state())
            except WireError as e:
                raise ValueError(
                    f"{direction} pipeline {spec!r} cannot round-trip a "
                    f"payload (incoherent stage order?): {e}") from e


# --------------------------------------------------------------------------
# The transport interface
# --------------------------------------------------------------------------
class Transport(abc.ABC):
    """Factory for one protocol's sender/receiver state machines."""

    name: str = "abstract"
    caps: TransportCaps = TransportCaps()

    @abc.abstractmethod
    def create_sender(self, sim: Simulator, src: Node, dst: Node,
                      packets: list[Packet], cfg: TransportConfig, *,
                      on_complete: Optional[Callable] = None,
                      on_fail: Optional[Callable] = None):
        """One transaction: ship ``packets`` from ``src`` to ``dst``.
        Returns an un-started sender; the caller invokes ``.start()``."""

    @abc.abstractmethod
    def create_receiver(self, sim: Simulator, node: Node,
                        cfg: TransportConfig, on_deliver: DeliverFn):
        """Persistent receiver on ``node``; fires ``on_deliver(Delivery)``
        exactly once per completed transaction."""


# --------------------------------------------------------------------------
# Registry (the make_codec idiom, with explicit registration)
# --------------------------------------------------------------------------
# The three built-ins register at the bottom of this module; mudp+fec
# registers when repro_torch.core.fec is imported, which the
# repro_torch.core package __init__ does eagerly (it cannot be imported
# here: fec imports this module for the public API).
_REGISTRY: dict[str, Callable[[], Transport]] = {}


def register_transport(name: str, factory: Callable[[], Transport], *,
                       overwrite: bool = False) -> None:
    """Register ``factory`` (usually a Transport subclass) under ``name``.

    Re-registering an existing name raises unless ``overwrite=True`` — a
    silent shadowing of "mudp" would invalidate every benchmark comparison.
    """
    if not overwrite and name in _REGISTRY:
        raise ValueError(f"transport {name!r} is already registered "
                         f"(pass overwrite=True to replace it)")
    _REGISTRY[name] = factory


def make_transport(name: str) -> Transport:
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown transport {name!r}; registered transports: "
            f"{available_transports()}") from None
    return factory()


def available_transports() -> list[str]:
    return sorted(_REGISTRY)


def validate_transport_kind(kind: str) -> None:
    """Raise ValueError (naming the registered transports) for unknown kinds."""
    if kind not in _REGISTRY:
        raise ValueError(
            f"unknown transport kind {kind!r}; registered transports: "
            f"{available_transports()}")


# --------------------------------------------------------------------------
# Built-in transports: thin adapters over the existing state machines
# --------------------------------------------------------------------------
def adapt_full_delivery(on_deliver: DeliverFn):
    """Adapt the reliable 3-arg callback (addr, txn, packets) -> Delivery."""
    def _cb(sender_addr: str, txn: int, packets: dict[int, Packet]) -> None:
        total = next(iter(packets.values())).total if packets else 0
        on_deliver(Delivery(sender_addr, txn, packets, total, complete=True))
    return _cb


def adapt_partial_delivery(on_deliver: DeliverFn):
    """Adapt the best-effort 4-arg callback (addr, txn, packets, total)."""
    def _cb(sender_addr: str, txn: int, packets: dict[int, Packet],
            total: int) -> None:
        complete = len(packets) == total
        on_deliver(Delivery(sender_addr, txn, packets, total, complete))
    return _cb


class MudpTransport(Transport):
    """The paper's Modified UDP: NACK-driven selective repeat (§IV.B)."""

    name = "mudp"
    caps = TransportCaps(reliable=True, partial_delivery=False,
                         has_handshake=False, supports_fail_cb=True,
                         concurrent_txns=True)

    def create_sender(self, sim, src, dst, packets, cfg, *,
                      on_complete=None, on_fail=None):
        return MudpSender(sim, src, dst, packets,
                          timeout_ns=cfg.timeout_ns,
                          max_retries=cfg.max_retries,
                          on_complete=on_complete, on_fail=on_fail)

    def create_receiver(self, sim, node, cfg, on_deliver):
        return MudpReceiver(sim, node, nack_timeout_ns=cfg.timeout_ns,
                            max_nack_retries=cfg.max_retries,
                            on_deliver=adapt_full_delivery(on_deliver))


class UdpTransport(Transport):
    """Plain UDP baseline: fire-and-forget, delivers whatever arrived."""

    name = "udp"
    caps = TransportCaps(reliable=False, partial_delivery=True,
                         has_handshake=False, supports_fail_cb=False,
                         concurrent_txns=True)

    def create_sender(self, sim, src, dst, packets, cfg, *,
                      on_complete=None, on_fail=None):
        # No retry budget to exhaust -> on_fail can never fire (see caps).
        return UdpSender(sim, src, dst, packets, on_complete=on_complete)

    def create_receiver(self, sim, node, cfg, on_deliver):
        return UdpReceiver(sim, node, deadline_ns=cfg.udp_deadline_ns,
                           on_deliver=adapt_partial_delivery(on_deliver))


class TcpTransport(Transport):
    """Reno-lite TCP baseline: handshake + cumulative ACKs + windowing."""

    name = "tcp"
    caps = TransportCaps(reliable=True, partial_delivery=False,
                         has_handshake=True, supports_fail_cb=True,
                         concurrent_txns=True)

    def create_sender(self, sim, src, dst, packets, cfg, *,
                      on_complete=None, on_fail=None):
        return TcpSender(sim, src, dst, packets, rto_ns=cfg.timeout_ns,
                         on_complete=on_complete, on_fail=on_fail)

    def create_receiver(self, sim, node, cfg, on_deliver):
        return TcpReceiver(sim, node,
                           on_deliver=adapt_full_delivery(on_deliver))


register_transport("mudp", MudpTransport)
register_transport("udp", UdpTransport)
register_transport("tcp", TcpTransport)
