"""pytree <-> packets.

Algorithm I of the paper: get_weights() -> ConvertToHex -> one packet per
weight. Shipping one packet per scalar weight does not survive contact with a
34B-parameter model, so the production packetizer flattens the parameter
pytree to one float32 vector, encodes it through a **wire pipeline**
(``repro_torch.core.wire`` — a composed stage list; a bare legacy codec is wrapped
into a single-stage headerless pipeline, hex remains available as the
faithful mode), and slices the byte stream into MTU-sized packets with the
paper's (X, Np, A) headers. The receiver side reassembles, verifies
checksums, decodes (self-describing payloads decode from their own
WireHeader), and unflattens against the model template (the FL server knows
the architecture — only weight bytes travel, exactly as in the paper).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Optional

import numpy as np

from repro_torch.core.compression import Codec, RawCodec
from repro_torch.core.packets import Packet, make_data_packet
from repro_torch.core.wire import (Pipeline, PipelineState, WireError,
                             decode_payload, stage_for_codec)

DEFAULT_MTU = 1500
_IP_UDP_OVERHEAD = 28  # bytes of IP+UDP headers a real datagram would carry


# --------------------------------------------------------------------------
# pytree <-> flat vector
# --------------------------------------------------------------------------
def tree_leaves(tree: Any) -> list:
    """The leaves of a parameter tree in JAX's pytree order: dict keys
    **sorted** (JAX flattens dicts by sorted key; ``torch.utils._pytree``
    keeps insertion order, which would move every wire byte), lists and
    tuples in order, ``None`` as an empty subtree, anything else a leaf."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    if tree is None:
        return []
    return [tree]


def _rebuild(template: Any, leaves: Iterator) -> Any:
    """A tree shaped like ``template`` whose leaves come from ``leaves``,
    consumed in :func:`tree_leaves` order."""
    if isinstance(template, dict):
        out = {key: _rebuild(template[key], leaves)
               for key in sorted(template)}
        return {key: out[key] for key in template}
    if isinstance(template, (list, tuple)):
        items = [_rebuild(sub, leaves) for sub in template]
        if isinstance(template, list):
            return items
        if hasattr(template, "_fields"):          # namedtuple
            return type(template)(*items)
        return type(template)(items)
    if template is None:
        return None
    return next(leaves)


def tree_map(fn: Callable, *trees: Any) -> Any:
    """``fn`` applied leafwise across trees shaped like ``trees[0]``."""
    groups = zip(*(tree_leaves(t) for t in trees))
    return _rebuild(trees[0], iter([fn(*group) for group in groups]))


def flatten_to_vector(tree: Any) -> np.ndarray:
    """Deterministic (pytree order) concat of all leaves as float32."""
    leaves = tree_leaves(tree)
    if not leaves:
        return np.zeros(0, dtype=np.float32)
    return np.concatenate(
        [np.asarray(leaf, dtype=np.float32).reshape(-1) for leaf in leaves])


def unflatten_from_vector(vec: np.ndarray, template: Any) -> Any:
    """Rebuild a tree shaped like ``template`` from a flat float32 vector."""
    out, off = [], 0
    for leaf in tree_leaves(template):
        leaf = np.asarray(leaf)
        n = leaf.size
        out.append(vec[off:off + n].reshape(leaf.shape).astype(leaf.dtype))
        off += n
    if off != vec.size:
        raise ValueError(f"vector has {vec.size} params, template needs {off}")
    return _rebuild(template, iter(out))


def num_params(tree: Any) -> int:
    return sum(int(np.asarray(leaf).size) for leaf in tree_leaves(tree))


# --------------------------------------------------------------------------
# bytes <-> packets
# --------------------------------------------------------------------------
def packetize(data: bytes, addr: str, txn: int = 0,
              mtu: int = DEFAULT_MTU) -> list[Packet]:
    """Slice ``data`` into DATA packets with headers (X, Np, A), X=1..Np."""
    payload_max = mtu - _IP_UDP_OVERHEAD
    if payload_max <= 0:
        raise ValueError("mtu too small")
    total = max(1, -(-len(data) // payload_max))
    return [
        make_data_packet(seq=i + 1, total=total, addr=addr, txn=txn,
                         payload=data[i * payload_max:(i + 1) * payload_max])
        for i in range(total)
    ]


def reassemble(packets: dict[int, Packet]) -> bytes:
    """Receiver §IV.B: 'Construct the original file from the packets.'"""
    if not packets:
        return b""
    total = next(iter(packets.values())).total
    missing = [s for s in range(1, total + 1) if s not in packets]
    if missing:
        raise ValueError(f"cannot reassemble, missing sequences {missing}")
    chunks = []
    for seq in range(1, total + 1):
        pkt = packets[seq]
        if not pkt.verify():
            raise ValueError(f"checksum mismatch at sequence {seq}")
        chunks.append(pkt.payload)
    return b"".join(chunks)


# --------------------------------------------------------------------------
# High-level: model <-> packets
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Packetizer:
    """End-to-end path used by FL clients and the server broadcast.

    Construct with a legacy ``codec`` (wrapped into a single-stage
    headerless pipeline — byte-identical to the historical wire format) or
    with an explicit ``pipeline`` (a composed, usually self-describing
    stage list from ``repro_torch.core.wire``).  Stateful pipelines take an
    optional per-endpoint ``PipelineState`` on every call; ``None`` means
    stateless one-shot encoding.
    """

    codec: Optional[Codec] = None
    mtu: int = DEFAULT_MTU
    pipeline: Optional[Pipeline] = None

    def __post_init__(self) -> None:
        if self.pipeline is None:
            if self.codec is None:
                self.codec = RawCodec()
            self.pipeline = Pipeline([stage_for_codec(self.codec)],
                                     self_describing=False)
        elif self.codec is not None:
            raise WireError(
                "pass either codec= (legacy single-stage) or pipeline=, "
                "not both — the codec would be silently ignored")

    def encode_bytes(self, tree: Any,
                     state: Optional[PipelineState] = None) -> bytes:
        return self.pipeline.encode(flatten_to_vector(tree), state)

    def decode_bytes(self, data: bytes,
                     state: Optional[PipelineState] = None) -> np.ndarray:
        """Wire bytes -> flat float32 vector.  Self-describing payloads
        decode from their own header (honoring whatever pipeline the sender
        chose); legacy payloads decode through this packetizer's pipeline.
        Raises ``WireDecodeError`` for anything malformed."""
        if self.pipeline.self_describing:
            vec, _ = decode_payload(data, state)
            return vec
        return self.pipeline.decode(data, state)

    def to_packets(self, tree: Any, addr: str, txn: int = 0,
                   state: Optional[PipelineState] = None) -> list[Packet]:
        return packetize(self.encode_bytes(tree, state), addr, txn, self.mtu)

    def from_packets(self, packets: dict[int, Packet], template: Any,
                     state: Optional[PipelineState] = None) -> Any:
        vec = self.decode_bytes(reassemble(packets), state)
        return unflatten_from_vector(vec, template)

