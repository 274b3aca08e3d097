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
``int8(1024)`` to ``int8(256)`` mid-run needs no out-of-band sync — the
receiver decodes whatever the header declares.  Encoder state survives
the swap under the :func:`repro_torch.core.wire.migrate_state` rules (EF
residual and delta reference carry over; everything else resets).

Built-ins:

* ``static`` — the default: a no-op that never returns a decision.  The
  24 orchestrator-equivalence digests are pinned with this policy, which
  is the proof the control plane is a pure add-on.
The reference's ``adaptive`` policy (a loss-driven ladder over top-k
sparsity and FEC parity) arrives with the ``topk`` stage and ``mudp+fec``
in a later slice of the port.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.core.telemetry import ClientHealth


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
    ``overwrite=True`` (silently shadowing ``static`` would invalidate
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


register_policy("static", StaticPolicy)
