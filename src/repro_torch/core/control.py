"""Adaptive transport control plane: policies that renegotiate the wire.

The other half of the loop closed by :mod:`repro_torch.core.telemetry`: a
registry-keyed :class:`ControlPolicy` (the transport/stage/topology/model
registry idiom) that the server consults **between transactions** — at
sync round starts and async session entries — and that may renegotiate
one client's uplink/downlink pipeline spec and FEC geometry from its
:class:`~repro_torch.core.telemetry.ClientHealth`.

The renegotiation itself is carried entirely in-band: every
self-describing payload already names its pipeline in its
:class:`~repro_torch.core.wire.WireHeader`, so a client that switches from
``topk(0.4)`` to ``topk(0.04)`` mid-run needs no out-of-band sync — the
receiver decodes whatever the header declares.  Encoder state survives
the swap under the :func:`repro_torch.core.wire.migrate_state` rules (EF
residual and delta reference carry over; everything else resets).

Built-ins:

* ``static`` — the default: a no-op that never returns a decision.  The
  24 orchestrator-equivalence digests are pinned with this policy, which
  is the proof the control plane is a pure add-on.
* ``adaptive`` — a tiered escalation ladder driven by the loss-rate EWMA:
  clients observing heavy retransmission (congested edge) escalate top-k
  sparsity and FEC parity so their updates fit the round; clients on
  clean fiber relax to lighter compression and drop FEC overhead.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.core.telemetry import ClientHealth

#: TransportConfig fields a decision may renegotiate.
DECISION_FIELDS = ("uplink", "downlink", "fec_block", "fec_parity")


@dataclass(frozen=True)
class ControlDecision:
    """One client's renegotiated transport parameters.

    ``None`` fields are left untouched; the server compares the rest
    against the client's current effective config and applies (and
    counts) only actual changes, so a policy may return its target
    configuration unconditionally.  ``reset_state=True`` drops the
    client's encoder state (EF residual, delta reference) instead of
    migrating it — the explicit-reset migration rule.
    """

    uplink: Optional[str] = None
    downlink: Optional[str] = None
    fec_block: Optional[int] = None
    fec_parity: Optional[int] = None
    reset_state: bool = False


class ControlPolicy(abc.ABC):
    """Decide, per client and per scheduling opportunity, whether to
    renegotiate.  Policies must be deterministic functions of the
    telemetry they are shown (no RNG, no wall clock): the simulation's
    replay guarantees extend through the control plane."""

    name: str = "abstract"

    @abc.abstractmethod
    def renegotiate(self, addr: str, health: Optional[ClientHealth],
                    cfg) -> Optional[ControlDecision]:
        """``health`` is the client's snapshot (None before any
        observation); ``cfg`` its current effective
        :class:`~repro_torch.core.transport.TransportConfig`.  Return a
        :class:`ControlDecision` or None to leave the client alone."""


# --------------------------------------------------------------------------
# Registry (the transport-registry idiom)
# --------------------------------------------------------------------------
_POLICIES: dict[str, Callable[..., ControlPolicy]] = {}


def register_policy(name: str, factory: Callable[..., ControlPolicy], *,
                    overwrite: bool = False) -> None:
    """Register ``factory`` under ``name``; called with
    ``FLConfig.control_args``.  Re-registering raises unless
    ``overwrite=True`` (silently shadowing ``adaptive`` would invalidate
    every benchmark that names it)."""
    if not overwrite and name in _POLICIES:
        raise ValueError(f"control policy {name!r} is already registered "
                         f"(pass overwrite=True to replace it)")
    _POLICIES[name] = factory


def make_policy(name: str, **kwargs) -> ControlPolicy:
    try:
        factory = _POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown control policy {name!r}; registered policies: "
            f"{available_policies()}") from None
    return factory(**kwargs)


def available_policies() -> list[str]:
    return sorted(_POLICIES)


# --------------------------------------------------------------------------
# static — the pinned no-op
# --------------------------------------------------------------------------
class StaticPolicy(ControlPolicy):
    """Never renegotiates anything.  ``FLConfig.control='static'`` (the
    default) does not even construct one — the server skips the control
    step entirely — but the class exists so ``make_policy('static')``
    works and third-party code can subclass the do-nothing baseline."""

    name = "static"

    def renegotiate(self, addr, health, cfg):
        return None


# --------------------------------------------------------------------------
# adaptive — loss-driven tier ladder
# --------------------------------------------------------------------------
#: The default ladder, light -> heavy.  All tiers share the uplink's
#: delta/ef prefix so (a) the aggregation domain never changes across a
#: swap (the server refuses domain flips) and (b) the EF residual carries
#: over and keeps compensating across tier switches.  ``fec_parity=0``
#: disables the FEC trailer outright (clean fiber pays zero overhead).
DEFAULT_TIERS = (
    {"uplink": "delta|ef|topk(0.4)|int8(1024)",
     "fec_block": 16, "fec_parity": 0},
    {"uplink": "delta|ef|topk(0.15)|int8(1024)",
     "fec_block": 8, "fec_parity": 1},
    {"uplink": "delta|ef|topk(0.04)|int8(1024)",
     "fec_block": 4, "fec_parity": 2},
)


class AdaptivePolicy(ControlPolicy):
    """Move each client along a compression/parity ladder by its observed
    loss-rate EWMA: ``>= hi`` steps one tier heavier, ``<= lo`` one tier
    lighter, in between holds (the hi/lo gap is the hysteresis band that
    keeps borderline clients from flapping).  Tiers, thresholds and the
    starting rung come from ``FLConfig.control_args``."""

    name = "adaptive"

    def __init__(self, *, tiers=None, hi: float = 0.03, lo: float = 0.008,
                 min_txns: int = 1, start_tier: int = 1):
        self.tiers = tuple(dict(t) for t in
                           (tiers if tiers is not None else DEFAULT_TIERS))
        if not self.tiers:
            raise ValueError("adaptive policy needs at least one tier")
        for t in self.tiers:
            unknown = set(t) - set(DECISION_FIELDS)
            if unknown:
                raise ValueError(f"tier {t} sets unknown transport fields "
                                 f"{sorted(unknown)}")
        if not 0.0 <= lo <= hi:
            raise ValueError(f"need 0 <= lo <= hi, got lo={lo} hi={hi}")
        if not 0 <= start_tier < len(self.tiers):
            raise ValueError(f"start_tier {start_tier} out of range for "
                             f"{len(self.tiers)} tiers")
        self.hi = float(hi)
        self.lo = float(lo)
        self.min_txns = int(min_txns)
        self.start_tier = int(start_tier)
        self._tier: dict[str, int] = {}

    def tier_of(self, addr: str) -> int:
        return self._tier.get(addr, self.start_tier)

    def renegotiate(self, addr, health, cfg):
        if health is None or health.txns < self.min_txns:
            return None
        cur = self.tier_of(addr)
        if health.loss_rate >= self.hi:
            new = min(cur + 1, len(self.tiers) - 1)
        elif health.loss_rate <= self.lo:
            new = max(cur - 1, 0)
        else:
            new = cur
        self._tier[addr] = new
        t = self.tiers[new]
        # Returned unconditionally: the server deduplicates against the
        # client's current config, so holding a tier costs nothing.
        return ControlDecision(
            uplink=t.get("uplink"), downlink=t.get("downlink"),
            fec_block=t.get("fec_block"), fec_parity=t.get("fec_parity"))


register_policy("static", StaticPolicy)
register_policy("adaptive", AdaptivePolicy)
