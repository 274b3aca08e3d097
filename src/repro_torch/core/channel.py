"""Channel models for the discrete-event network simulator.

A link is (data_rate, propagation_delay, loss model).

Loss models are deterministic given a seed (or an explicit drop predicate), so
every test and benchmark replays bit-for-bit — the NS3-equivalent of a fixed
RngSeedManager seed.  All stochastic draws (loss, burst state, jitter) are
counter-based keyed uniforms (splitmix64 over the packet identity) with a
single array-shaped implementation, so the per-packet and batched simulator
engines produce identical values by construction.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional, Sequence

import numpy as np

from repro_torch.core.packets import Packet, PacketKind

NS_PER_SEC = 1_000_000_000

# Payload-bearing kinds are subject to stochastic loss; small control packets
# (ACK/NACK/SYN/...) only drop when drop_control=True. FEC parity rides the
# same links as data and must be just as losable, or comparisons against
# non-FEC transports would be biased.
_PAYLOAD_KINDS = frozenset({PacketKind.DATA, PacketKind.PARITY})


# --------------------------------------------------------------------------
# Keyed, counter-based uniform draws (the replay-stable RNG)
# --------------------------------------------------------------------------
# Every stochastic decision in the channel layer is a *pure function* of a
# per-packet key (stream tag, model seed, txn, kind, seq, attempt): no
# generator state ever advances, so replays are bit-identical regardless of
# event interleaving, and a whole burst of draws can be computed as one
# vectorized numpy expression — which is what the batched flight engine
# (``Simulator(engine="batched")``) relies on.  There is exactly ONE
# implementation of the draw (array-shaped); the per-packet path calls it
# with length-1 arrays, so the two engines cannot diverge by construction.
#
# The mixer is the splitmix64 finalizer — a full-avalanche 64-bit hash whose
# xor/shift/multiply steps are identical under python ints (masked to 64
# bits) and ``np.uint64`` wrap-around arithmetic.
_MASK64 = (1 << 64) - 1
_MIX_BASE = 0x9E3779B97F4A7C15          # golden-ratio offset
_M1, _M2 = 0xBF58476D1CE4E5B9, 0x94D049BB133111EB

# Distinct stream tags keep the loss / burst-state / jitter draws
# decorrelated even when their model seeds are equal (same role as the old
# 0x117E2 jitter tag, now one per stream).
LOSS_STREAM = 0x10D5
BURST_STREAM = 0x6E11
JITTER_STREAM = 0x117E2
# Flow-engine draws (repro_torch.core.flow): burst-level binomial loss
# counts, stochastic rounding of expected-value recursions, missing-seq
# selection.  Its own tag so a flow run's draws are decorrelated from the
# per-packet streams that share the same (seed, txn, ...) key material.
FLOW_STREAM = 0xF7011
_NP_M1, _NP_M2 = np.uint64(_M1), np.uint64(_M2)
_NP_S30, _NP_S27, _NP_S31 = np.uint64(30), np.uint64(27), np.uint64(31)
_NP_S11 = np.uint64(11)
_INV_2_53 = float(2.0 ** -53)


def _mix_int(x: int) -> int:
    """splitmix64 finalizer on a python int (used only for the scalar key
    prefix; the per-packet tail runs through :func:`_mix_arr`)."""
    x = ((x ^ (x >> 30)) * _M1) & _MASK64
    x = ((x ^ (x >> 27)) * _M2) & _MASK64
    return x ^ (x >> 31)


def _mix_arr(x: np.ndarray) -> np.ndarray:
    """The same finalizer on a ``np.uint64`` array (wrap-around multiply)."""
    x = (x ^ (x >> _NP_S30)) * _NP_M1
    x = (x ^ (x >> _NP_S27)) * _NP_M2
    return x ^ (x >> _NP_S31)


def keyed_uniforms(stream: int, seed: int, txns: np.ndarray,
                   kinds: np.ndarray, seqs: np.ndarray,
                   attempts: np.ndarray) -> np.ndarray:
    """One uniform [0, 1) draw per packet, keyed by
    ``(stream, seed, txn, kind, seq, attempt)``.

    ``txns``/``kinds``/``seqs``/``attempts`` are parallel ``np.uint64``
    arrays; the result is ``float64`` with full 53-bit resolution.  The
    draw for a given key is the same whether it is computed alone or as
    part of a burst — the property the engine-equivalence tests pin down.
    """
    h0 = _mix_int(_MIX_BASE ^ (stream & _MASK64))
    h0 = _mix_int(h0 ^ (seed & _MASK64))
    h = _mix_arr(np.uint64(h0) ^ txns)
    h = _mix_arr(h ^ kinds)
    h = _mix_arr(h ^ seqs)
    h = _mix_arr(h ^ attempts)
    return (h >> _NP_S11) * _INV_2_53


def keyed_uniform(stream: int, seed: int, pkt: Packet) -> float:
    """Scalar form: the identical draw for one packet, via the python-int
    splitmix chain (the uint64 wrap-around arithmetic is the same math as
    :func:`_mix_arr`, so the scalar and array paths agree bit for bit)."""
    h = _mix_int(_MIX_BASE ^ (stream & _MASK64))
    h = _mix_int(h ^ (seed & _MASK64))
    h = _mix_int(h ^ pkt.txn)
    h = _mix_int(h ^ int(pkt.kind))
    h = _mix_int(h ^ pkt.seq)
    h = _mix_int(h ^ pkt.attempt)
    return (h >> 11) * _INV_2_53


def flow_uniform(stream: int, seed: int, a: int, b: int = 0, c: int = 0,
                 d: int = 0) -> float:
    """One keyed uniform [0, 1) draw from raw integer key material — the
    same splitmix64 chain as :func:`keyed_uniform` without requiring a
    :class:`Packet`.  The flow engine keys its burst-level draws on
    ``(txn, phase, counter, attempt)`` tuples that have no packet identity.
    """
    h = _mix_int(_MIX_BASE ^ (stream & _MASK64))
    h = _mix_int(h ^ (seed & _MASK64))
    h = _mix_int(h ^ (a & _MASK64))
    h = _mix_int(h ^ (b & _MASK64))
    h = _mix_int(h ^ (c & _MASK64))
    h = _mix_int(h ^ (d & _MASK64))
    return (h >> 11) * _INV_2_53


def keyed_binomial(n: int, p: float, u: float) -> int:
    """Binomial(n, p) sample by CDF inversion from one uniform ``u``.

    A deterministic, platform-stable walk up the pmf recurrence
    ``pmf(k+1) = pmf(k) * (n-k) p / ((k+1)(1-p))`` — no generator state,
    no numpy Generator (whose binomial algorithm is not guaranteed stable
    across versions).  O(n) worst case but terminates near ``n*p`` for the
    loss rates links model; exact for the degenerate edges.
    """
    if n <= 0 or p <= 0.0:
        return 0
    if p >= 1.0:
        return n
    q = 1.0 - p
    pmf = q ** n
    if pmf == 0.0:
        # Underflow (huge n, large p): fall back to a normal-approximation
        # quantile, clamped — the regime where per-k inversion is hopeless.
        mean, sd = n * p, math.sqrt(n * p * q)
        # Acklam-style inverse CDF is overkill; a 4-term rational
        # approximation of the probit is plenty at these tolerances.
        x = max(1e-12, min(1.0 - 1e-12, u))
        t = math.sqrt(-2.0 * math.log(min(x, 1.0 - x)))
        z = t - (2.30753 + 0.27061 * t) / (1.0 + 0.99229 * t
                                           + 0.04481 * t * t)
        if x < 0.5:
            z = -z
        return max(0, min(n, int(round(mean + sd * z))))
    cdf, k = pmf, 0
    ratio = p / q
    while u >= cdf and k < n:
        pmf *= (n - k) * ratio / (k + 1)
        k += 1
        cdf += pmf
    return k


def stochastic_round(x: float, u: float) -> int:
    """``floor(x) + (u < frac(x))`` — integerize an expected value so the
    mean is preserved exactly while every replay of the same key gives the
    same integer (the flow engine's retx counts stay replayable)."""
    base = int(x)
    return base + (1 if u < (x - base) else 0)


def packet_key_arrays(pkts: Sequence[Packet]
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray]:
    """(txns, kinds, seqs, attempts) as ``np.uint64`` arrays, in send order."""
    n = len(pkts)
    txns = np.fromiter((p.txn for p in pkts), np.uint64, n)
    kinds = np.fromiter((int(p.kind) for p in pkts), np.uint64, n)
    seqs = np.fromiter((p.seq for p in pkts), np.uint64, n)
    attempts = np.fromiter((p.attempt for p in pkts), np.uint64, n)
    return txns, kinds, seqs, attempts


def _payload_kind_mask(kinds: np.ndarray) -> np.ndarray:
    mask = kinds == np.uint64(int(PacketKind.DATA))
    for k in _PAYLOAD_KINDS:
        if k != PacketKind.DATA:
            mask |= kinds == np.uint64(int(k))
    return mask


# --------------------------------------------------------------------------
# Loss models
# --------------------------------------------------------------------------
class LossModel:
    """Decides whether a given transmission of a packet is dropped."""

    def drops(self, pkt: Packet) -> bool:  # pragma: no cover - interface
        raise NotImplementedError

    def stationary_loss_p(self) -> float:
        """The model's marginal per-payload-packet drop probability — what
        the flow engine (``Simulator(engine="flow")``) uses for its
        burst-level Binomial loss draws.  Models whose drops are not an
        exchangeable per-packet event (e.g. :class:`DropList`) have no
        meaningful stationary rate and refuse, which in turn makes the
        flow engine refuse the link."""
        raise NotImplementedError(
            f"{type(self).__name__} defines no stationary loss "
            f"probability; the flow engine cannot model this link")

    def drop_mask(self, pkts: Sequence[Packet], txns: np.ndarray,
                  kinds: np.ndarray, seqs: np.ndarray,
                  attempts: np.ndarray) -> np.ndarray:
        """Vectorized form for one burst: bool array, True = dropped.

        The key arrays are the burst's :func:`packet_key_arrays`.  The
        default falls back to per-packet :meth:`drops`, so any custom loss
        model stays bit-identical under the batched engine without writing
        a vectorized path.
        """
        return np.fromiter((self.drops(p) for p in pkts), bool, len(pkts))


class NoLoss(LossModel):
    def drops(self, pkt: Packet) -> bool:
        return False

    def drop_mask(self, pkts, txns, kinds, seqs, attempts) -> np.ndarray:
        return np.zeros(len(pkts), bool)

    def stationary_loss_p(self) -> float:
        return 0.0


@dataclasses.dataclass
class DropList(LossModel):
    """Drop exact (seq, attempt) pairs — reproduces the paper's test cases,
    where the client 'deliberately skips' specific sequence numbers on the
    first transmission only.

    ``drops_on`` entries are ``(seq, attempt)``; attempt 0 is the initial
    transmission. DATA packets only — control packets always pass (as in the
    paper's scenarios).
    """

    drops_on: frozenset

    def __init__(self, pairs: Iterable[tuple[int, int]]):
        self.drops_on = frozenset(pairs)

    def drops(self, pkt: Packet) -> bool:
        if pkt.kind != PacketKind.DATA:
            return False
        return (pkt.seq, pkt.attempt) in self.drops_on


@dataclasses.dataclass
class BernoulliLoss(LossModel):
    """IID loss with probability ``p``, deterministic per (txn, seq, attempt,
    kind) so replays are stable regardless of event interleaving."""

    p: float
    seed: int = 0
    drop_control: bool = False  # whether ACK/NACK packets can also be lost

    def drops(self, pkt: Packet) -> bool:
        if self.p <= 0.0:
            return False
        if not self.drop_control and pkt.kind not in _PAYLOAD_KINDS:
            return False
        return keyed_uniform(LOSS_STREAM, self.seed, pkt) < self.p

    def drop_mask(self, pkts, txns, kinds, seqs, attempts) -> np.ndarray:
        if self.p <= 0.0:
            return np.zeros(len(pkts), bool)
        mask = keyed_uniforms(LOSS_STREAM, self.seed, txns, kinds, seqs,
                              attempts) < self.p
        if not self.drop_control:
            mask &= _payload_kind_mask(kinds)
        return mask

    def stationary_loss_p(self) -> float:
        return max(0.0, min(1.0, self.p))


@dataclasses.dataclass
class GilbertElliott(LossModel):
    """Two-state bursty loss (good/bad) — the standard WAN burst-loss model.

    State advances per transmission attempt, keyed deterministically by a
    per-packet hash so that the model is replayable; this is a mean-field
    variant (per-packet independent two-state mixture) adequate for sweeps.
    """

    p_good_loss: float = 0.001
    p_bad_loss: float = 0.3
    p_bad: float = 0.05          # stationary probability of the bad state
    seed: int = 0
    drop_control: bool = False

    def drops(self, pkt: Packet) -> bool:
        if not self.drop_control and pkt.kind not in _PAYLOAD_KINDS:
            return False
        bad = keyed_uniform(BURST_STREAM, self.seed, pkt) < self.p_bad
        p = self.p_bad_loss if bad else self.p_good_loss
        return keyed_uniform(LOSS_STREAM, self.seed, pkt) < p

    def drop_mask(self, pkts, txns, kinds, seqs, attempts) -> np.ndarray:
        bad = keyed_uniforms(BURST_STREAM, self.seed, txns, kinds, seqs,
                             attempts) < self.p_bad
        p = np.where(bad, self.p_bad_loss, self.p_good_loss)
        mask = keyed_uniforms(LOSS_STREAM, self.seed, txns, kinds, seqs,
                              attempts) < p
        if not self.drop_control:
            mask &= _payload_kind_mask(kinds)
        return mask

    def stationary_loss_p(self) -> float:
        # This implementation is a mean-field per-packet two-state mixture
        # (state keyed independently per packet), so the two-state closed
        # form IS the exact marginal, not an approximation.
        return self.p_bad * self.p_bad_loss + (1.0 - self.p_bad) \
            * self.p_good_loss


# --------------------------------------------------------------------------
# Links
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Link:
    """Point-to-point link: serialization at ``data_rate_bps`` plus
    ``delay_ns`` propagation (optionally jittered), with an attached loss
    model.

    Serialization occupies the link (FIFO): back-to-back sends queue behind
    each other, matching NS3 PointToPointNetDevice semantics.

    ``jitter_ns`` adds a per-packet propagation jitter drawn uniformly from
    ``[0, jitter_ns)``, keyed deterministically by (jitter_seed, txn, kind,
    seq, attempt) — the same replay-stable idiom as :class:`BernoulliLoss`,
    so a fleet of hundreds of jittered links still replays bit-for-bit.
    Jitter can reorder packets in flight, which is exactly the wide-area
    behaviour the MUDP gap machinery has to absorb.  The batched engine
    draws a whole burst's jitter at once via :meth:`propagation_array`.
    """

    data_rate_bps: float = 5_000_000.0       # paper: 5 Mbps
    delay_ns: int = 2_000_000_000            # paper: 2000 ms
    loss: LossModel = dataclasses.field(default_factory=NoLoss)
    jitter_ns: int = 0                       # uniform extra delay in [0, jitter_ns)
    jitter_seed: int = 0
    # Busy-until bookkeeping (owned by the simulator).
    _busy_until_ns: int = 0

    def serialization_ns(self, size_bytes: int) -> int:
        return int(round(size_bytes * 8 * NS_PER_SEC / self.data_rate_bps))

    def propagation_ns(self, pkt: Optional[Packet] = None) -> int:
        """Propagation delay for one transmission of ``pkt``."""
        if self.jitter_ns <= 0 or pkt is None:
            return self.delay_ns
        # JITTER_STREAM keeps this stream decorrelated from the loss models'
        # draws, which key the same (seed, txn, kind, seq, attempt) shape —
        # with one tag, equal seeds would make drop and jitter draws the
        # same number, biasing delivered-packet jitter upward.
        return self.delay_ns + int(
            keyed_uniform(JITTER_STREAM, self.jitter_seed, pkt)
            * self.jitter_ns)

    def propagation_array(self, txns: np.ndarray, kinds: np.ndarray,
                          seqs: np.ndarray, attempts: np.ndarray
                          ) -> np.ndarray:
        """Per-packet propagation delays for one burst (int64 ns), drawing
        every jitter value in one vectorized shot — the same values
        :meth:`propagation_ns` produces packet by packet."""
        n = len(seqs)
        if self.jitter_ns <= 0:
            return np.full(n, self.delay_ns, np.int64)
        u = keyed_uniforms(JITTER_STREAM, self.jitter_seed, txns, kinds,
                           seqs, attempts)
        return self.delay_ns + (u * self.jitter_ns).astype(np.int64)

    def expected_propagation_ns(self) -> int:
        """Mean propagation delay — base delay plus the expectation of the
        uniform [0, jitter_ns) jitter.  The flow engine charges every
        packet this mean instead of drawing per-packet jitter."""
        return self.delay_ns + self.jitter_ns // 2

    def reset(self) -> None:
        self._busy_until_ns = 0



# Link presets, as ``Link(**preset)`` keyword sets (the reference's).
PAPER_LINK = dict(data_rate_bps=5_000_000.0, delay_ns=2_000_000_000)
# Cross-pod DCN-class link: 25 Gbps effective per stream, 1 ms RTT/2.
DCN_LINK = dict(data_rate_bps=25_000_000_000.0, delay_ns=500_000)
# Cross-region WAN: 2 Gbps, 30 ms one-way.
WAN_LINK = dict(data_rate_bps=2_000_000_000.0, delay_ns=30_000_000)
