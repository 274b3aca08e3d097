"""Packet model for the Modified UDP (MUDP) transport.

The paper's sequence header is the triple ``(X, Np, A)``:

* ``X``  -- sequence number of this packet, ``1 <= X <= Np`` for data packets.
* ``Np`` -- total number of packets in the transaction.
* ``A``  -- address of the sender of this packet.

Control packets reuse the triple:

* success acknowledgement is ``(0, 0, A_receiver)`` (paper §IV.B),
* a NACK for missing sequence ``X`` is ``(X, Np, A_receiver)`` flagged as NACK.

Checksums guard payload integrity (the paper assumes NS3 delivers intact
packets; a real UDP deployment needs this, so it is first-class here).
"""

from __future__ import annotations

import dataclasses
import enum
import struct
import zlib


class PacketKind(enum.IntEnum):
    """Wire discriminator for every packet the framework can emit."""

    DATA = 0        # carries a payload chunk, header (X, Np, A)
    ACK_OK = 1      # transaction complete, header (0, 0, A)
    NACK = 2        # receiver reports missing sequence X, header (X, Np, A)
    # TCP-baseline control packets.
    SYN = 3
    SYN_ACK = 4
    ACK = 5         # cumulative ack (TCP baseline), X = next expected seq
    FIN = 6
    # FL orchestration control.
    ROUND_BEGIN = 7
    HEARTBEAT = 8
    # Forward-error-correction (mudp+fec): XOR parity over a block of DATA
    # packets, header (parity_index, n_parity, A).
    PARITY = 9


# Wire header: kind(B) seq(I) total(I) txn(I) payload_len(I) checksum(I) = 21B,
# plus a 16-byte fixed-width address field -> 37 bytes, comparable to a real
# UDP/IP header budget.
_HEADER_FMT = "!BIIII"
_ADDR_BYTES = 16
HEADER_BYTES = struct.calcsize(_HEADER_FMT) + 4 + _ADDR_BYTES


def checksum32(payload: bytes) -> int:
    """Adler-32 checksum of a packet payload."""
    return zlib.adler32(payload) & 0xFFFFFFFF


@dataclasses.dataclass(frozen=True, slots=True)
class Packet:
    """One simulated datagram.

    ``seq``/``total``/``addr`` are the paper's ``(X, Np, A)``. ``txn`` tags the
    transaction (one model transfer) so concurrent transfers from many FL
    clients never collide at the server. ``attempt`` counts (re)transmissions
    of this sequence number — it exists only for loss-model determinism and
    does not travel on the wire (NS3 equivalent: the send event identity).
    """

    kind: PacketKind
    seq: int
    total: int
    addr: str
    txn: int = 0
    payload: bytes = b""
    checksum: int = 0
    attempt: int = 0

    # -- paper-visible representation ------------------------------------
    def header(self) -> tuple[int, int, str]:
        """The paper's ``(X, Np, A)`` triple."""
        return (self.seq, self.total, self.addr)

    def __str__(self) -> str:  # e.g. "(2, 4, 10.1.2.4)" as printed in Figs 5-7
        return f"({self.seq}, {self.total}, {self.addr})"

    # -- sizes -------------------------------------------------------------
    @property
    def size_bytes(self) -> int:
        return HEADER_BYTES + len(self.payload)

    @property
    def is_last(self) -> bool:
        return self.kind == PacketKind.DATA and self.seq == self.total

    def verify(self) -> bool:
        return checksum32(self.payload) == self.checksum



def make_data_packet(seq: int, total: int, addr: str, payload: bytes,
                     txn: int = 0) -> Packet:
    return Packet(PacketKind.DATA, seq, total, addr, txn, payload,
                  checksum32(payload))


def make_ack_ok(addr: str, txn: int = 0) -> Packet:
    """Paper §IV.B: 'send an acknowledgement with sequence number (0, 0, A)'."""
    return Packet(PacketKind.ACK_OK, 0, 0, addr, txn)


def make_nack(missing_seq: int, total: int, addr: str, txn: int = 0,
              payload: bytes = b"") -> Packet:
    """NACK for one missing sequence number (paper sends one per gap)."""
    return Packet(PacketKind.NACK, missing_seq, total, addr, txn, payload,
                  checksum32(payload))
