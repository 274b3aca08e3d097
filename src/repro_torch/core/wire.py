"""Composable wire-plane: self-describing codec pipelines.

The single-stage ``Codec`` string on :class:`TransportConfig` couples three
decisions that scale differently — *what* to ship (weights vs deltas), *how*
to shrink it (sparsify, quantize), and *how the receiver knows what it got*
(out-of-band config vs the wire itself).  This module separates them:

* :class:`Stage` — one reversible transform over a flat float32 vector with
  a per-endpoint/per-direction mutable state slot.  Stages compose:
  ``delta`` (ship trained - received), ``ef`` (error-feedback residual,
  wrapping everything downstream of it), ``topk(f)`` (sparsify to values +
  index sidecar), ``int8(b)`` (blockwise absmax quantization), ``raw`` /
  ``hex`` (terminal serializers), ``crc`` (end-to-end body checksum).
* :class:`Pipeline` — an ordered stage list parsed from a ``|``-separated
  spec string (``"delta|ef|topk(0.01)|int8(1024)"``) with **derived**
  capability flags (:class:`PipelineCaps`: lossless, stateful, estimated
  wire ratio, delta-domain) so callers branch on what a pipeline guarantees,
  never on its spelling.
* :class:`WireHeader` — a versioned header prepended to every
  self-describing payload: magic, wire version, the canonical pipeline spec,
  and each stage's dynamic per-message params.  The receiver rebuilds the
  pipeline **from the wire** via the stage registry and decodes with zero
  out-of-band knowledge; malformed or truncated payloads raise
  :class:`WireDecodeError` with a reason instead of being swallowed by a
  bare ``except``.
* the registry — ``register_stage`` / ``parse_pipeline`` /
  ``available_stages``, mirroring the transport registry, so third-party
  stages participate in specs and in wire negotiation for free.

**Legacy mode.**  ``Pipeline`` also runs *headerless* (``self_describing=
False``): the terminal stage emits exactly the historical ``Codec`` wire
bytes (``repro_torch.core.compression``) and transform stages touch
only local state.  This is how ``TransportConfig(codec="int8")`` keeps producing
byte-identical traffic — the 24 pinned orchestrator-equivalence digests are
the proof that the redesign is a pure refactor on that path.

State model: a :class:`Pipeline` object is immutable/shareable; everything
mutable (delta references, EF residuals) lives in a :class:`PipelineState`
created per (endpoint, direction) via :meth:`Pipeline.new_state`.  Decode
is stateless for every built-in stage, which is what makes decoding from
the header alone possible.

**Batch plane.**  Every stage also exposes ``encode_batch`` /
``decode_batch`` over stacked ``(N, P)`` matrices (base-class fallbacks
loop; the built-ins override with vectorized numpy, and ``int8`` and
``topk`` with the CUDA quantize and top-k kernels — see
:func:`set_batch_backend`).  :meth:`Pipeline.
encode_batch`, :meth:`Pipeline.decode_batch` and
:func:`decode_payload_batch` walk all N clients through each stage in one
call: per-client state (delta refs, EF residuals) is gathered into an
``(N, P)`` slab on entry and scattered back into the per-client
:class:`PipelineState` slots on exit, so batched and looped execution see
the exact same state evolution.  The contract is strict: batch encode is
byte-identical to the per-item loop and batch decode bit-identical, which
is what lets the orchestrator batch by default without moving any of the
24 pinned equivalence digests.
"""

from __future__ import annotations

import abc
import binascii
import contextlib
import struct
from typing import Callable, Optional, Sequence

import numpy as np

import torch

from repro_torch import device as _device
from repro_torch.core.compression import (MAX_DECODE_PARAMS, HexCodec,
                                          Int8Codec, RawCodec, TopKCodec,
                                          dequantize_int8_batch,
                                          quantize_int8_batch, topk_indices)
from repro_torch.kernels import KernelError
from repro_torch.kernels.quantize import ops as _quant_ops
from repro_torch.kernels.topk import ops as _topk_ops

_U16 = struct.Struct("!H")
_U32 = struct.Struct("!I")
_U64 = struct.Struct("!Q")

#: Wire magic + current header version.  Bump the version for any layout
#: change; receivers reject versions they do not understand explicitly.
WIRE_MAGIC = b"WP"
WIRE_VERSION = 1

#: Body dtypes a terminal stage may emit, indexed by the code stored in the
#: header.  Codes are append-only (removing or reordering would silently
#: reinterpret old payloads).
_BODY_DTYPES: tuple[str, ...] = ("<f4", "i1", "u1", "<u4")


class WireError(ValueError):
    """Mis-use of the wire API (bad spec, bad composition, bad config)."""


class WireDecodeError(WireError):
    """A payload that cannot be decoded: wrong magic, unknown version or
    stage, truncated header/params/body, or a count mismatch inside a
    stage.  The FL layer degrades these *explicitly* (zero-fill + counter),
    anything else propagates."""


def _body_dtype_code(dtype: np.dtype) -> int:
    s = np.dtype(dtype).str.lstrip("=|")
    for i, d in enumerate(_BODY_DTYPES):
        if np.dtype(d) == np.dtype(dtype):
            return i
    raise WireError(f"unsupported body dtype {s!r}")


# --------------------------------------------------------------------------
# Per-direction state
# --------------------------------------------------------------------------
class PipelineState:
    """Mutable state for one (endpoint, direction): one dict slot per stage.

    Created by :meth:`Pipeline.new_state`; the orchestrator keeps one per
    client per direction, which is where delta references and EF residuals
    live (they used to live on ``FLClient`` / inside ``ServerCore``).
    """

    def __init__(self, n_stages: int):
        self.slots: list[dict] = [{} for _ in range(n_stages)]

    def copy(self) -> "PipelineState":
        """Slot-shallow copy: stages replace slot values wholesale (never
        mutate arrays in place), so copying the dicts is enough to run a
        what-if encode without touching the live state."""
        out = PipelineState(len(self.slots))
        out.slots = [dict(s) for s in self.slots]
        return out

    def __repr__(self) -> str:
        keys = [sorted(s) for s in self.slots]
        return f"PipelineState({keys})"


# --------------------------------------------------------------------------
# Stage ABC
# --------------------------------------------------------------------------
class Stage(abc.ABC):
    """One composable wire transform over numpy arrays.

    ``encode(arr, slot) -> (arr_out, params)``: transform the array and
    return the dynamic per-message params the *decoder* needs (goes into
    the :class:`WireHeader`; empty for stages that are self-inverse).
    ``decode(arr, params, slot)`` inverts it.  Both sides receive a mutable
    per-(endpoint, direction) ``slot`` dict; decode must work with an empty
    slot for the built-ins (wire negotiation decodes with fresh state).

    Class attributes drive the derived pipeline capabilities: ``lossless``
    (decode∘encode is the identity), ``stateful`` (encode reads/writes the
    slot), ``est_ratio`` (estimated encoded-bytes / input-bytes, used by
    planners and benchmarks — an estimate, not a promise).

    **Batch twins.**  ``encode_batch`` / ``decode_batch`` process N stacked
    items at once; the base-class versions loop over ``encode`` /
    ``decode`` and set ``batch_capable = False``, which makes the pipeline
    take the per-item path.  A vectorized override must (a) set
    ``batch_capable = True``, (b) be byte-identical on encode and
    bit-identical on decode to the loop (``tests/test_torch_wire.py`` pins
    the built-ins against the reference's bytes), and (c) raise
    :class:`WireDecodeError` when the group's per-item params are not
    uniform enough to vectorize — the caller then degrades to per-item
    decode.  A subclass that overrides ``encode``/``decode`` without
    overriding the batch twins must reset ``batch_capable = False`` or the
    inherited vectorized twin will silently bypass its override.
    """

    name: str = "abstract"
    lossless: bool = True
    stateful: bool = False
    est_ratio: float = 1.0
    # The encoded array is a difference against a reference the decoder
    # does not reconstruct (decode stays in the delta domain).  Drives
    # PipelineCaps.delta_domain — declare it on third-party delta-like
    # stages so the server aggregates them correctly; such stages receive
    # the reference via slot["ref"] from Pipeline.set_reference.
    delta_domain: bool = False
    # Encode output is not coordinate-aligned with its input (reordered,
    # re-lengthed, or re-typed).  An `ef` stage must not follow one: its
    # residual would be added across mismatched coordinates.
    remaps_coordinates: bool = False

    @abc.abstractmethod
    def encode(self, arr: np.ndarray, slot: dict
               ) -> tuple[np.ndarray, bytes]: ...

    @abc.abstractmethod
    def decode(self, arr: np.ndarray, params: bytes,
               slot: dict) -> np.ndarray: ...

    def spec(self) -> str:
        """Canonical spec token; ``parse_stage(s.spec())`` reconstructs."""
        return self.name

    # -- legacy (headerless) terminal serialization -------------------------
    # Implemented only by the classic codec stages (raw/hex/int8/topk):
    # byte-identical to the historical repro_torch.core.compression wire formats.
    legacy_codec = None   # a compression.Codec instance, or None

    def legacy_encode(self, vec: np.ndarray) -> bytes:
        if self.legacy_codec is None:
            raise WireError(f"stage {self.name!r} cannot terminate a "
                            f"legacy (headerless) pipeline")
        return self.legacy_codec.encode(vec)

    def legacy_decode(self, data: bytes) -> np.ndarray:
        if self.legacy_codec is None:
            raise WireError(f"stage {self.name!r} cannot terminate a "
                            f"legacy (headerless) pipeline")
        return self.legacy_codec.decode(data)

    # -- batch plane ---------------------------------------------------------
    #: True when encode_batch/decode_batch are genuinely vectorized.  The
    #: base-class fallbacks below just loop — correct for any stage — so a
    #: Pipeline only takes the one-call batched walk when EVERY stage
    #: opts in.
    batch_capable: bool = False

    def encode_batch(self, batch: np.ndarray, slots: Sequence[dict]
                     ) -> tuple[np.ndarray, list[bytes]]:
        """Encode N stacked items: ``(N, P) -> ((N, P'), [params] * N)``.

        ``slots[i]`` is item i's per-(endpoint, direction) state dict —
        the same object :meth:`encode` would receive.  Fallback: loops
        over :meth:`encode` one row at a time and stacks the outputs
        (raising :class:`WireError` if a stage produces ragged rows).
        """
        rows, params = [], []
        for i in range(batch.shape[0]):
            arr, p = self.encode(batch[i], slots[i])
            rows.append(arr)
            params.append(p)
        return _stack_rows(rows, self.spec()), params

    def decode_batch(self, arr: np.ndarray, params: Sequence[bytes],
                     slots: Sequence[dict]) -> np.ndarray:
        """Inverse of :meth:`encode_batch` over a rectangular group.

        Callers only attempt batch decode on groups that are already
        uniform in spec, body dtype and body length; an override must
        still verify the per-item *params* agree (e.g. one topk count for
        the whole group) and raise :class:`WireDecodeError` otherwise —
        the caller then isolates the odd item via per-item decode.
        """
        rows = [self.decode(arr[i], params[i], slots[i])
                for i in range(arr.shape[0])]
        return _stack_rows(rows, self.spec())


def _require_f4(arr: np.ndarray, stage: str) -> np.ndarray:
    arr = np.asarray(arr)
    if arr.dtype != np.dtype("<f4"):
        raise WireError(f"stage {stage!r} requires a float32 input, got "
                        f"{arr.dtype} (check stage order in the spec)")
    return arr


def _require_f4_batch(batch: np.ndarray, stage: str) -> np.ndarray:
    batch = np.asarray(batch)
    if batch.ndim != 2:
        raise WireError(f"stage {stage!r} batch input must be 2-D (N, P), "
                        f"got shape {batch.shape}")
    if batch.dtype != np.dtype("<f4"):
        raise WireError(f"stage {stage!r} requires a float32 input, got "
                        f"{batch.dtype} (check stage order in the spec)")
    return batch


def _stack_rows(rows: Sequence[np.ndarray], what: str) -> np.ndarray:
    """Stack per-item outputs into a rectangle, or explain why we cannot."""
    if not rows:
        return np.zeros((0, 0), dtype=np.float32)
    arrs = [np.asarray(r) for r in rows]
    if len({a.shape for a in arrs}) != 1:
        raise WireError(f"{what!r} produced ragged batch rows (shapes "
                        f"{sorted({a.shape for a in arrs})}); batch calls "
                        f"need a rectangle")
    return np.stack(arrs)


# --------------------------------------------------------------------------
# Batch backend: the CUDA stage kernels (default) or vectorized numpy
# --------------------------------------------------------------------------
WIRE_BATCH_BACKENDS = ("numpy", "kernel")

_BATCH_BACKEND = "kernel"

#: Rows per vectorized walk are capped so the chunk's working set stays
#: cache-resident: a monolithic (256, 250k) walk streams every
#: intermediate through DRAM and loses to the per-item loop, while
#: a few-MB chunk keeps the batch plane ahead at every size.  Per-item
#: independence makes chunking invisible to the byte/bit-identity
#: contract.
_BATCH_CHUNK_ELEMS = 1 << 20


def _batch_chunk_rows(row_elems: int) -> int:
    return max(1, _BATCH_CHUNK_ELEMS // max(1, row_elems))


def batch_backend() -> str:
    """The active ``int8`` / ``topk`` stage backend (``"kernel"`` or
    ``"numpy"``)."""
    return _BATCH_BACKEND


def set_batch_backend(name: str) -> str:
    """Select the ``int8`` / ``topk`` stage backend; returns the previous.

    ``"kernel"`` (the default) runs int8 quantize/dequantize through
    :mod:`repro_torch.kernels.quantize` and the top-k value gather (encode)
    and scatter (decode) through :mod:`repro_torch.kernels.topk`, per item
    and in batch, on the package's current device
    (:mod:`repro_torch.device`): the hand-written CUDA kernels on
    ``cuda``, their plain PyTorch versions on ``cpu``.  The block size is
    passed to the kernel, so every ``int8(b)`` reaches it.  Top-k index
    *selection* stays numpy on the host under both backends.  ``"numpy"``
    is the host codec in :mod:`repro_torch.core.compression`.  Both are bit
    for bit the same, so flipping the backend never changes a byte.
    """
    global _BATCH_BACKEND
    if name not in WIRE_BATCH_BACKENDS:
        raise WireError(f"unknown batch backend {name!r}; choose from "
                        f"{WIRE_BATCH_BACKENDS}")
    prev = _BATCH_BACKEND
    _BATCH_BACKEND = name
    return prev


@contextlib.contextmanager
def using_batch_backend(name: str):
    """Run the block under backend ``name``, then restore the previous."""
    prev = set_batch_backend(name)
    try:
        yield
    finally:
        set_batch_backend(prev)


@contextlib.contextmanager
def _kernel_failure(what: str):
    """Re-raise any failure of the device side of a ``"kernel"`` stage op
    (no card, a build, a launch, a copy) as :class:`KernelError`.  The
    stages check the payload's shape before they get here, so such a
    failure is never a malformed payload and must not be degraded into
    a zero-filled row like a :class:`WireDecodeError`."""
    try:
        yield
    except KernelError:
        raise
    except Exception as e:
        raise KernelError(f"{what} on the {_BATCH_BACKEND!r} backend "
                          f"failed: {type(e).__name__}: {e}") from e


def _on_device(arr: np.ndarray, dtype) -> torch.Tensor:
    """Host array -> tensor on the package's current device.  Wire buffers
    are often read-only views of received bytes, which torch cannot wrap,
    so those are copied once."""
    arr = np.ascontiguousarray(arr, dtype=dtype)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(_device.resolve())


def _quantize_rows(mat: np.ndarray, block: int
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Row-wise int8 quantize of an ``(N, P)`` float32 matrix on the
    active backend: ``(q (N, nb*block) int8, scales (N, nb) f32)``."""
    if _BATCH_BACKEND == "numpy" or mat.size == 0:
        return quantize_int8_batch(mat, block)
    with _kernel_failure("int8 quantize"):
        q, scales = _quant_ops.quantize(_on_device(mat, np.float32), block)
        return q.cpu().numpy(), scales.cpu().numpy()


def _dequantize_rows(q: np.ndarray, scales: np.ndarray, n: int,
                     block: int) -> np.ndarray:
    """Inverse of :func:`_quantize_rows`: ``(N, n)`` float32."""
    if _BATCH_BACKEND == "numpy" or q.size == 0:
        return dequantize_int8_batch(q, scales, n, block)
    with _kernel_failure("int8 dequantize"):
        out = _quant_ops.dequantize(_on_device(q, np.int8),
                                    _on_device(scales, np.float32), n, block)
        return out.cpu().numpy()


def _gather_rows(mat: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``mat[r, idx[r, k]]`` of an ``(N, P)`` float32 matrix at ``(N, K)``
    u32 indices below ``P``, on the active backend."""
    if _BATCH_BACKEND == "numpy" or idx.size == 0:
        return np.take_along_axis(mat, idx.astype(np.int64), axis=1)
    with _kernel_failure("topk gather"):
        out = _topk_ops.topk_gather(_on_device(mat, np.float32),
                                    _on_device(idx, np.int32))
        return out.cpu().numpy()


def _scatter_rows(idx: np.ndarray, vals: np.ndarray, n: int) -> np.ndarray:
    """Dense ``(N, n)`` float32 rows, zero except ``vals`` at ``idx`` (u32,
    already checked ``< n <= MAX_DECODE_PARAMS``, so they fit int32).  A
    duplicate index resolves last-wins on both backends, like the per-item
    ``out[idx] = vals``."""
    n_items, k = idx.shape
    if _BATCH_BACKEND == "numpy" or idx.size == 0:
        out = np.zeros((n_items, n), dtype=np.float32)
        # Flat fancy assignment: duplicate indices resolve last-wins in
        # row-major order, exactly like the per-item out[idx] = vals.
        rows = np.repeat(np.arange(n_items), k)
        out[rows, idx.reshape(-1).astype(np.int64)] = vals.reshape(-1)
        return out
    with _kernel_failure("topk scatter"):
        out = _topk_ops.topk_scatter(_on_device(idx, np.int32),
                                     _on_device(vals, np.float32), n)
        return out.cpu().numpy()


# --------------------------------------------------------------------------
# Transform stages: delta, ef
# --------------------------------------------------------------------------
class DeltaStage(Stage):
    """Ship ``vec - reference`` instead of ``vec``.

    The encoder's slot holds the reference (the model the endpoint last
    received), primed by the orchestrator via
    :meth:`Pipeline.set_reference`; an unprimed reference counts as zero,
    so the first update is a delta against the zero model.  Decode is the
    identity: the receiver *aggregates in the delta domain*
    (``PipelineCaps.delta_domain`` tells it to), it never reconstructs the
    sender's full model.
    """

    name = "delta"
    lossless = True
    stateful = True
    est_ratio = 1.0
    delta_domain = True

    def encode(self, arr, slot):
        arr = _require_f4(arr, self.name)
        ref = slot.get("ref")
        if ref is None:
            return arr, b""
        if ref.size != arr.size:
            raise WireError(f"delta reference has {ref.size} params, "
                            f"update has {arr.size}")
        return arr - ref, b""

    def decode(self, arr, params, slot):
        return arr

    batch_capable = True

    def encode_batch(self, batch, slots):
        batch = _require_f4_batch(batch, self.name)
        refs = [slot.get("ref") for slot in slots]
        for ref in refs:
            if ref is not None and ref.size != batch.shape[1]:
                raise WireError(f"delta reference has {ref.size} params, "
                                f"update has {batch.shape[1]}")
        if all(ref is None for ref in refs):
            out = batch
        elif any(ref is None for ref in refs):
            # Mixed priming (some endpoints have never seen a model):
            # subtract row-wise, unprimed rows pass through untouched.
            out = batch.copy()
            for i, ref in enumerate(refs):
                if ref is not None:
                    out[i] = batch[i] - ref
        else:
            out = batch - np.stack(refs)
        return out, [b""] * batch.shape[0]

    def decode_batch(self, arr, params, slots):
        return arr


class ErrorFeedbackStage(Stage):
    """Residual compensation (Seide et al. 2014) for everything downstream.

    Encode-side only: the pipeline transmits ``tail(vec + residual)`` and
    stores ``residual = (vec + residual) - tail_decoded`` in the slot, so
    whatever the lossy tail dropped this message is re-injected into the
    next one.  Decode is the identity.  The tail round-trip is orchestrated
    by :class:`Pipeline` (this stage wraps everything after it).
    """

    name = "ef"
    lossless = True          # adds information back, never discards it
    stateful = True
    est_ratio = 1.0

    def compensate(self, arr: np.ndarray, slot: dict) -> np.ndarray:
        arr = _require_f4(arr, self.name)
        residual = slot.get("residual")
        if residual is None:
            return arr
        return arr + residual

    def update(self, compensated: np.ndarray, decoded: np.ndarray,
               slot: dict) -> None:
        slot["residual"] = compensated - decoded

    def encode(self, arr, slot):     # pragma: no cover - pipeline intercepts
        raise WireError("ef is applied by Pipeline (it wraps the tail); "
                        "it cannot be encoded standalone")

    def decode(self, arr, params, slot):
        return arr

    # Batch twins of compensate/update: one add / one subtract across the
    # (N, P) slab, with residual rows gathered from / scattered back to the
    # per-client slots.  Subclasses overriding compensate/update must
    # override these too (or reset batch_capable) — see the Stage docs.
    batch_capable = True

    def compensate_batch(self, batch: np.ndarray,
                         slots: Sequence[dict]) -> np.ndarray:
        batch = _require_f4_batch(batch, self.name)
        residuals = [slot.get("residual") for slot in slots]
        if all(r is None for r in residuals):
            return batch
        if all(r is not None and r.size == batch.shape[1]
               for r in residuals):
            return batch + np.stack(residuals)
        out = batch.copy()
        for i, r in enumerate(residuals):
            if r is not None:
                out[i] = batch[i] + r
        return out

    def update_batch(self, compensated: np.ndarray, decoded: np.ndarray,
                     slots: Sequence[dict]) -> None:
        diff = compensated - decoded
        for i, slot in enumerate(slots):
            # copy() so a slot never pins the whole (N, P) slab alive.
            slot["residual"] = diff[i].copy()

    def decode_batch(self, arr, params, slots):
        return arr


# --------------------------------------------------------------------------
# Compression stages: topk, int8
# --------------------------------------------------------------------------
class TopKStage(Stage):
    """Keep the ``k = max(1, k_fraction * n)`` largest-|x| entries.

    Encode emits the kept *values* as the flowing vector (so a downstream
    quantizer compresses them further) and ``n`` + the sorted indices as
    params.  Wire cost ≈ ``8 bytes/kept`` alone, less when composed.
    Index selection is numpy on the host; the value gather (encode) and
    scatter (decode) run on the backend chosen by :func:`set_batch_backend`,
    per item and in batch.
    """

    name = "topk"
    lossless = False
    stateful = False
    remaps_coordinates = True     # output = values at per-message indices

    def __init__(self, k_fraction: float = 0.01):
        if not 0.0 < k_fraction <= 1.0:
            raise WireError(f"topk fraction must be in (0, 1], "
                            f"got {k_fraction}")
        self.k_fraction = float(k_fraction)
        self.est_ratio = 2.0 * self.k_fraction   # (u4 idx + f4 val) per kept
        self.legacy_codec = TopKCodec(k_fraction=self.k_fraction)

    def spec(self) -> str:
        return f"topk({self.k_fraction:g})"

    def encode(self, arr, slot):
        arr = _require_f4(arr, self.name)
        k = min(arr.size, max(1, int(arr.size * self.k_fraction)))
        idx = topk_indices(arr, k)
        vals = _gather_rows(arr.reshape(1, -1), idx.reshape(1, -1))
        params = _U64.pack(arr.size) + idx.astype("<u4").tobytes()
        return np.ascontiguousarray(vals.reshape(-1), dtype="<f4"), params

    def decode(self, arr, params, slot):
        if len(params) < 8:
            raise WireDecodeError("topk params truncated")
        n = _U64.unpack_from(params, 0)[0]
        if n > MAX_DECODE_PARAMS:
            # A wire-controlled u64 must never size an allocation
            # unchecked (and u32 indices cannot address beyond 2**32
            # anyway); the cap lives in repro_torch.core.compression.
            raise WireDecodeError(f"topk n={n} exceeds MAX_DECODE_PARAMS "
                                  f"({MAX_DECODE_PARAMS})")
        idx = np.frombuffer(params, dtype="<u4", offset=8)
        vals = np.asarray(arr, dtype=np.float32)
        if idx.size != vals.size:
            raise WireDecodeError(f"topk index/value count mismatch: "
                                  f"{idx.size} vs {vals.size}")
        if idx.size and (n == 0 or int(idx.max()) >= n):
            raise WireDecodeError("topk index out of range")
        return _scatter_rows(idx.reshape(1, -1), vals.reshape(1, -1),
                             n).reshape(-1)

    batch_capable = True

    def encode_batch(self, batch, slots):
        batch = _require_f4_batch(batch, self.name)
        n_items, n = batch.shape
        k = min(n, max(1, int(n * self.k_fraction)))
        if k <= 0:       # only when n == 0: an empty sparsification
            idx = np.zeros((n_items, 0), dtype="<u4")
            vals = np.zeros((n_items, 0), dtype="<f4")
        else:
            # Selection stays numpy even on the kernel backend:
            # np.argpartition's introselect runs per row under axis=1, so
            # each row picks the same index SET as the 1-D call inside
            # topk_indices (pinned by the batch==loop parity sweep), and
            # sorting makes the byte layout identical.
            idx = np.sort(np.argpartition(np.abs(batch), -k, axis=1)[:, -k:],
                          axis=1).astype("<u4")
            vals = _gather_rows(batch, idx)
        head = _U64.pack(n)
        # One bulk tobytes + C-level slicing beats n_items row tobytes.
        blob, step = np.ascontiguousarray(idx).tobytes(), 4 * k
        params = ([head + blob[o:o + step]
                   for o in range(0, n_items * step, step)]
                  if step else [head] * n_items)
        return np.ascontiguousarray(vals, dtype="<f4"), params

    def decode_batch(self, arr, params, slots):
        if not params:
            return np.zeros((0, 0), dtype=np.float32)
        if len(params[0]) < 8:
            raise WireDecodeError("topk params truncated")
        head = params[0][:8]
        if any(len(p) != len(params[0]) or p[:8] != head for p in params):
            # Mixed n or k across the group: degrade to per-item decode
            # rather than guess a rectangle.
            raise WireDecodeError("topk batch group is not uniform")
        n = _U64.unpack_from(head, 0)[0]
        if n > MAX_DECODE_PARAMS:
            raise WireDecodeError(f"topk n={n} exceeds MAX_DECODE_PARAMS "
                                  f"({MAX_DECODE_PARAMS})")
        vals = np.asarray(arr, dtype=np.float32)
        n_items = vals.shape[0]
        k, rem = divmod(len(params[0]) - 8, 4)
        if rem or k != vals.shape[1]:
            raise WireDecodeError(f"topk index/value count mismatch: "
                                  f"{k} vs {vals.shape[1]}")
        if k == 0:
            return np.zeros((n_items, n), dtype=np.float32)
        # Uniform group (checked above): join once, view as a (N, k) u4
        # matrix past the 8-byte heads — no per-item frombuffer.
        buf = np.frombuffer(b"".join(params), dtype=np.uint8)
        idx = np.ascontiguousarray(
            buf.reshape(n_items, 8 + 4 * k)[:, 8:]).view("<u4")
        if n == 0 or int(idx.max()) >= n:
            raise WireDecodeError("topk index out of range")
        return _scatter_rows(idx, vals, n)


class Int8Stage(Stage):
    """Blockwise absmax int8 quantization (the ``quantize`` kernels' wire
    twin).  Encode emits the int8 values as the flowing array and
    ``n, block`` + per-block float32 scales as params.  Per-item and batch
    calls both run on the backend chosen by :func:`set_batch_backend`."""

    name = "int8"
    lossless = False
    remaps_coordinates = True     # block padding changes the length

    def __init__(self, block: int = 1024):
        if block < 1:
            raise WireError(f"int8 block must be >= 1, got {block}")
        self.block = int(block)
        self.est_ratio = 0.25 + 4.0 / (4.0 * self.block)  # q + scale share
        self.legacy_codec = Int8Codec(block=self.block)

    def spec(self) -> str:
        return f"int8({self.block})"

    def encode(self, arr, slot):
        arr = _require_f4(arr, self.name)
        q, scales = _quantize_rows(arr.reshape(1, -1), self.block)
        params = (_U64.pack(arr.size) + _U32.pack(self.block)
                  + scales.astype("<f4").tobytes())
        return q.reshape(-1), params

    def decode(self, arr, params, slot):
        if len(params) < 12:
            raise WireDecodeError("int8 params truncated")
        n = _U64.unpack_from(params, 0)[0]
        block = _U32.unpack_from(params, 8)[0]
        if block < 1:
            raise WireDecodeError("int8 block must be >= 1")
        scales = np.frombuffer(params, dtype="<f4", offset=12)
        q = np.asarray(arr)
        if q.dtype != np.int8:
            raise WireDecodeError(f"int8 body has dtype {q.dtype}, "
                                  f"expected int8")
        nb = -(-n // block) if n else 0
        if scales.size != nb or q.size != nb * block:
            raise WireDecodeError(
                f"int8 count mismatch: n={n} block={block} expects "
                f"{nb} scales / {nb * block} values, got "
                f"{scales.size} / {q.size}")
        return _dequantize_rows(q.reshape(1, -1), scales.reshape(1, -1),
                                n, block).reshape(-1)

    batch_capable = True

    def encode_batch(self, batch, slots):
        batch = _require_f4_batch(batch, self.name)
        n_items, n = batch.shape
        q, scales = _quantize_rows(batch, self.block)
        head = _U64.pack(n) + _U32.pack(self.block)
        blob = np.ascontiguousarray(scales, dtype="<f4").tobytes()
        step = 4 * scales.shape[1]
        params = ([head + blob[o:o + step]
                   for o in range(0, n_items * step, step)]
                  if step else [head] * n_items)
        return q, params

    def decode_batch(self, arr, params, slots):
        if not params:
            return np.zeros((0, 0), dtype=np.float32)
        if len(params[0]) < 12:
            raise WireDecodeError("int8 params truncated")
        head = params[0][:12]
        if any(len(p) != len(params[0]) or p[:12] != head for p in params):
            raise WireDecodeError("int8 batch group is not uniform")
        n = _U64.unpack_from(head, 0)[0]
        block = _U32.unpack_from(head, 8)[0]
        if block < 1:
            raise WireDecodeError("int8 block must be >= 1")
        q = np.asarray(arr)
        if q.dtype != np.int8:
            raise WireDecodeError(f"int8 body has dtype {q.dtype}, "
                                  f"expected int8")
        nb = -(-n // block) if n else 0
        n_scales = (len(params[0]) - 12) // 4
        if n_scales != nb or q.shape[1] != nb * block:
            raise WireDecodeError(
                f"int8 count mismatch: n={n} block={block} expects "
                f"{nb} scales / {nb * block} values, got "
                f"{n_scales} / {q.shape[1]}")
        if nb:
            buf = np.frombuffer(b"".join(params), dtype=np.uint8)
            scales = np.ascontiguousarray(
                buf.reshape(len(params), 12 + 4 * nb)[:, 12:]).view("<f4")
            scales = scales.astype(np.float32, copy=False)
        else:
            scales = np.zeros((len(params), 0), dtype=np.float32)
        return _dequantize_rows(q, scales, n, block)


# --------------------------------------------------------------------------
# Terminal serializers: raw, hex
# --------------------------------------------------------------------------
class RawStage(Stage):
    """Identity over float32 — the 4-bytes/param wire floor."""

    name = "raw"
    lossless = True
    est_ratio = 1.0
    legacy_codec = RawCodec()

    def encode(self, arr, slot):
        return np.ascontiguousarray(arr, dtype="<f4"), b""

    def decode(self, arr, params, slot):
        return np.asarray(arr, dtype=np.float32)

    batch_capable = True

    def encode_batch(self, batch, slots):
        batch = np.ascontiguousarray(batch, dtype="<f4")
        return batch, [b""] * batch.shape[0]

    def decode_batch(self, arr, params, slots):
        return np.asarray(arr, dtype=np.float32)


class HexStage(Stage):
    """The paper's codec (Algorithm I ``ConvertToHex``): hexlify the input
    bytes, 2x inflation.  Generic over input dtype (the code travels in
    params) so it composes after any stage."""

    name = "hex"
    lossless = True
    est_ratio = 2.0
    remaps_coordinates = True     # bytes-of-hex, not aligned floats
    legacy_codec = HexCodec()

    def encode(self, arr, slot):
        arr = np.ascontiguousarray(arr)
        code = _body_dtype_code(arr.dtype)
        out = np.frombuffer(binascii.hexlify(arr.tobytes()), dtype=np.uint8)
        return out, bytes([code])

    def decode(self, arr, params, slot):
        if len(params) != 1 or params[0] >= len(_BODY_DTYPES):
            raise WireDecodeError("hex params must be one dtype code")
        try:
            raw = binascii.unhexlify(np.ascontiguousarray(arr).tobytes())
        except binascii.Error as e:
            raise WireDecodeError(f"hex body is not hexadecimal: {e}") from e
        return np.frombuffer(raw, dtype=_BODY_DTYPES[params[0]]).copy()

    batch_capable = True

    def encode_batch(self, batch, slots):
        # Rows are contiguous, so hexlifying the whole (N, P) buffer is the
        # concatenation of the per-row hexlifys — one C call instead of N.
        batch = np.ascontiguousarray(batch)
        n_items = batch.shape[0]
        code = _body_dtype_code(batch.dtype)
        hexed = np.frombuffer(binascii.hexlify(batch.tobytes()),
                              dtype=np.uint8)
        out = (hexed.reshape(n_items, -1) if hexed.size
               else np.zeros((n_items, 0), dtype=np.uint8))
        return out, [bytes([code])] * n_items

    def decode_batch(self, arr, params, slots):
        if not params:
            return np.zeros((0, 0), dtype=np.float32)
        p0 = params[0]
        if len(p0) != 1 or p0[0] >= len(_BODY_DTYPES):
            raise WireDecodeError("hex params must be one dtype code")
        if any(p != p0 for p in params):
            raise WireDecodeError("hex batch group is not uniform")
        arr = np.ascontiguousarray(arr)
        n_items = arr.shape[0]
        if arr.shape[1] % 2:
            # Whole-buffer unhexlify would smear the odd row boundaries
            # together; per-item decode raises here too.
            raise WireDecodeError("hex body is not hexadecimal: "
                                  "odd-length row")
        try:
            raw = binascii.unhexlify(arr.tobytes())
        except binascii.Error as e:
            raise WireDecodeError(f"hex body is not hexadecimal: {e}") from e
        flat = np.frombuffer(raw, dtype=_BODY_DTYPES[p0[0]])
        return (flat.reshape(n_items, -1) if flat.size
                else np.zeros((n_items, 0), dtype=flat.dtype)).copy()


# --------------------------------------------------------------------------
# Integrity stage: crc
# --------------------------------------------------------------------------
#: ChunkSum-32 weight period (the reference's checksum kernel constant).
_CRC_WEIGHT_PERIOD = 8191


def chunksum32(data: bytes) -> int:
    """ChunkSum-32 over a byte string (numpy; the reference's checksum
    kernel is not on this slice's path).

    Every term is independent (weights are positional, not a running
    prefix like Adler-32), so the per-row batch form below is a plain
    vectorized reduction with identical results.
    """
    x = np.frombuffer(data, dtype=np.uint8)
    if x.size == 0:
        return 0
    w = (np.arange(x.size, dtype=np.uint64) % _CRC_WEIGHT_PERIOD) + 1
    xs = x.astype(np.uint64)
    a = int(xs.sum(dtype=np.uint64)) & 0xFFFFFFFF
    b = int((w * xs).sum(dtype=np.uint64)) & 0xFFFFFFFF
    return (a & 0xFFFF) | ((b & 0xFFFF) << 16)


def _chunksum32_rows(mat: np.ndarray) -> np.ndarray:
    """Per-row :func:`chunksum32` over a contiguous 2-D array (any dtype:
    rows are checksummed as their raw bytes)."""
    mat = np.ascontiguousarray(mat)
    rows = (mat.view(np.uint8).reshape(mat.shape[0], -1)
            if mat.size else np.zeros((mat.shape[0], 0), dtype=np.uint8))
    if rows.shape[1] == 0:
        return np.zeros(rows.shape[0], dtype=np.uint64)
    w = (np.arange(rows.shape[1], dtype=np.uint64)
         % _CRC_WEIGHT_PERIOD) + 1
    xs = rows.astype(np.uint64)
    a = xs.sum(axis=1, dtype=np.uint64) & 0xFFFFFFFF
    b = (xs * w).sum(axis=1, dtype=np.uint64) & 0xFFFFFFFF
    return (a & 0xFFFF) | ((b & 0xFFFF) << 16)


class CrcStage(Stage):
    """End-to-end wire-body integrity: ChunkSum-32 in the header params.

    Encode is the identity on the flowing array; the checksum of its
    exact bytes rides as this stage's header params.  Decode re-checksums
    the received body **before any other stage touches it** (it sits last
    in the spec, so it runs first on the reversed decode walk) and raises
    :class:`WireDecodeError` on mismatch — the FL layer's existing
    zero-fill degradation then absorbs the corrupt payload.

    Self-describing pipelines only (the checksum needs header params to
    travel in); ``Pipeline`` validation pins it to the terminal position
    because any later lossy stage would decode to different bytes than
    were checksummed and fail every payload.
    """

    name = "crc"
    lossless = True
    stateful = False
    est_ratio = 1.0
    remaps_coordinates = False
    legacy_codec = None

    def encode(self, arr, slot):
        arr = np.ascontiguousarray(arr)
        return arr, _U32.pack(chunksum32(arr.tobytes()))

    def decode(self, arr, params, slot):
        if len(params) != 4:
            raise WireDecodeError("crc params must be one u32 checksum")
        want = _U32.unpack(params)[0]
        got = chunksum32(np.ascontiguousarray(arr).tobytes())
        if got != want:
            raise WireDecodeError(f"crc mismatch: header 0x{want:08x}, "
                                  f"body 0x{got:08x}")
        return arr

    batch_capable = True

    def encode_batch(self, batch, slots):
        batch = np.ascontiguousarray(batch)
        if batch.ndim != 2:
            raise WireError(f"stage 'crc' batch input must be 2-D (N, P), "
                            f"got shape {batch.shape}")
        return batch, [_U32.pack(int(s)) for s in _chunksum32_rows(batch)]

    def decode_batch(self, arr, params, slots):
        if not params:
            return arr
        if any(len(p) != 4 for p in params):
            raise WireDecodeError("crc params must be one u32 checksum")
        arr = np.ascontiguousarray(arr)
        got = _chunksum32_rows(arr)
        want = np.frombuffer(b"".join(params), dtype=">u4")
        if got.size != want.size or not np.array_equal(
                got, want.astype(np.uint64)):
            raise WireDecodeError("crc mismatch in batch group")
        return arr


# --------------------------------------------------------------------------
# Registry + spec parser (the transport-registry idiom)
# --------------------------------------------------------------------------
_STAGES: dict[str, Callable[..., Stage]] = {}


def register_stage(name: str, factory: Callable[..., Stage], *,
                   overwrite: bool = False) -> None:
    """Register a stage factory under ``name``.  The factory is called with
    the (already number-parsed) args from the spec token, e.g.
    ``topk(0.01)`` calls ``factory(0.01)``.  Re-registering raises unless
    ``overwrite=True`` — silently shadowing ``int8`` would corrupt every
    payload already in flight under the old meaning."""
    if not overwrite and name in _STAGES:
        raise WireError(f"stage {name!r} is already registered "
                        f"(pass overwrite=True to replace it)")
    if overwrite:
        _NEGOTIATED.clear()   # memoized pipelines may hold the old stage
    _STAGES[name] = factory


def available_stages() -> list[str]:
    return sorted(_STAGES)


def _parse_number(tok: str) -> float | int:
    try:
        return int(tok)
    except ValueError:
        try:
            return float(tok)
        except ValueError:
            raise WireError(f"bad stage argument {tok!r}") from None


def parse_stage(token: str) -> Stage:
    """``"topk(0.01)"`` -> a TopKStage.  Raises WireError for unknown names
    or malformed args (WireDecodeError when reached from a wire header)."""
    token = token.strip()
    name, args = token, ()
    if "(" in token:
        if not token.endswith(")"):
            raise WireError(f"malformed stage token {token!r}")
        name, _, arg_s = token[:-1].partition("(")
        name = name.strip()
        if arg_s.strip():
            args = tuple(_parse_number(a.strip()) for a in arg_s.split(","))
    try:
        factory = _STAGES[name]
    except KeyError:
        raise WireError(f"unknown stage {name!r}; registered stages: "
                        f"{available_stages()}") from None
    try:
        return factory(*args)
    except WireError:
        raise
    except Exception as e:
        # Specs can arrive from the wire ('int8(inf)', 'raw(1)', ...): any
        # constructor rejection must stay inside the WireError contract so
        # the server degrades the payload instead of crashing.
        raise WireError(f"stage {name!r} rejected args {args!r}: "
                        f"{type(e).__name__}: {e}") from e


def parse_pipeline(spec: str) -> "Pipeline":
    """``"delta|ef|topk(0.01)|int8(1024)"`` -> a Pipeline (self-describing
    by default)."""
    tokens = [t for t in (tok.strip() for tok in spec.split("|")) if t]
    if not tokens:
        raise WireError(f"empty pipeline spec {spec!r}")
    return Pipeline([parse_stage(t) for t in tokens])


def parse_hop_specs(spec: str,
                    known_hops: Optional[Sequence[str]] = None
                    ) -> dict[str, str]:
    """Parse a *per-hop* pipeline spec string into ``{hop: pipeline spec}``.

    A multi-tier topology (``repro_torch.core.topology``) composes a different
    wire pipeline on every hop — e.g. a lossy sparsifying uplink from
    clients to their edge aggregator but a lossless delta on the
    aggregated edge->root link::

        "client->edge: topk(0.01)|int8(1024); edge->root: delta"

    Entries are ``;``-separated ``hop: pipeline`` pairs (the first ``:``
    splits, so stage arguments are unaffected).  Every pipeline is parsed
    eagerly — a typo'd stage fails here, at configuration time, not deep
    inside a round.  When ``known_hops`` is given, hop names outside it
    are rejected (each topology publishes its hop names).
    """
    out: dict[str, str] = {}
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        hop, sep, pipe = entry.partition(":")
        hop, pipe = hop.strip(), pipe.strip()
        if not sep or not hop or not pipe:
            raise WireError(f"malformed hop spec entry {entry!r}; expected "
                            f"'hop: stage|stage(...)'")
        if hop in out:
            raise WireError(f"duplicate hop {hop!r} in hop spec")
        if known_hops is not None and hop not in known_hops:
            raise WireError(f"unknown hop {hop!r}; this topology's hops: "
                            f"{sorted(known_hops)}")
        parse_pipeline(pipe)     # validate eagerly; raises WireError
        out[hop] = pipe
    if not out:
        raise WireError(f"empty hop spec {spec!r}")
    return out


# --------------------------------------------------------------------------
# The header
# --------------------------------------------------------------------------
class WireHeader:
    """``magic | version(u8) | spec_len(u16) spec | dtype(u8) |
    n_stages(u8) | per stage: params_len(u32) params`` — everything a
    receiver needs to rebuild the pipeline and decode the body."""

    __slots__ = ("version", "spec", "dtype_code", "stage_params")

    def __init__(self, spec: str, stage_params: list[bytes],
                 dtype_code: int, version: int = WIRE_VERSION):
        self.version = version
        self.spec = spec
        self.dtype_code = dtype_code
        self.stage_params = stage_params

    def pack(self) -> bytes:
        spec_b = self.spec.encode("utf-8")
        if len(spec_b) > 0xFFFF:
            raise WireError("pipeline spec too long")
        if len(self.stage_params) > 0xFF:
            raise WireError("too many stages")
        out = [WIRE_MAGIC, bytes([self.version]),
               _U16.pack(len(spec_b)), spec_b,
               bytes([self.dtype_code, len(self.stage_params)])]
        for p in self.stage_params:
            out.append(_U32.pack(len(p)))
            out.append(p)
        return b"".join(out)

    @classmethod
    def unpack(cls, data: bytes) -> tuple["WireHeader", int]:
        """Parse a header off the front of ``data``; returns (header, body
        offset).  Every malformation raises WireDecodeError with a reason."""
        if len(data) < 6:
            raise WireDecodeError(f"payload too short for a wire header "
                                  f"({len(data)} bytes)")
        if data[:2] != WIRE_MAGIC:
            raise WireDecodeError(f"bad wire magic {data[:2]!r}")
        version = data[2]
        if not 1 <= version <= WIRE_VERSION:
            raise WireDecodeError(f"unsupported wire version {version}")
        spec_len = _U16.unpack_from(data, 3)[0]
        off = 5
        if len(data) < off + spec_len + 2:
            raise WireDecodeError("truncated wire header (spec)")
        try:
            spec = data[off:off + spec_len].decode("utf-8")
        except UnicodeDecodeError as e:
            raise WireDecodeError(f"undecodable pipeline spec: {e}") from e
        off += spec_len
        dtype_code = data[off]
        if dtype_code >= len(_BODY_DTYPES):
            raise WireDecodeError(f"unknown body dtype code {dtype_code}")
        n_stages = data[off + 1]
        off += 2
        params: list[bytes] = []
        for _ in range(n_stages):
            if len(data) < off + 4:
                raise WireDecodeError("truncated wire header (params length)")
            plen = _U32.unpack_from(data, off)[0]
            off += 4
            if len(data) < off + plen:
                raise WireDecodeError("truncated wire header (params body)")
            params.append(data[off:off + plen])
            off += plen
        return cls(spec, params, dtype_code, version), off


# --------------------------------------------------------------------------
# Derived capabilities
# --------------------------------------------------------------------------
class PipelineCaps:
    """What a composed pipeline guarantees, derived from its stages."""

    __slots__ = ("lossless", "stateful", "est_ratio", "delta_domain")

    def __init__(self, stages: list[Stage]):
        self.lossless = all(s.lossless for s in stages)
        self.stateful = any(s.stateful for s in stages)
        ratio = 1.0
        for s in stages:
            ratio *= s.est_ratio
        self.est_ratio = ratio
        self.delta_domain = any(s.delta_domain for s in stages)

    def __repr__(self) -> str:
        return (f"PipelineCaps(lossless={self.lossless}, "
                f"stateful={self.stateful}, est_ratio={self.est_ratio:.4g}, "
                f"delta_domain={self.delta_domain})")


# --------------------------------------------------------------------------
# The pipeline
# --------------------------------------------------------------------------
class Pipeline:
    """An ordered, immutable stage composition.

    ``self_describing=True`` (the default, and what ``parse_pipeline``
    returns): ``encode`` prepends a :class:`WireHeader` and any receiver
    decodes via :func:`decode_payload` from the wire alone.
    ``self_describing=False`` (legacy): headerless — the terminal stage
    emits the historical codec bytes and ``decode`` needs this pipeline
    out-of-band, exactly the pre-refactor contract.
    """

    def __init__(self, stages: list[Stage], *, self_describing: bool = True):
        if not stages:
            raise WireError("a pipeline needs at least one stage")
        if isinstance(stages[-1], ErrorFeedbackStage):
            raise WireError("ef cannot be the terminal stage "
                            "(it wraps the stages after it)")
        ef_seen = remapped = False
        for s in stages:
            if isinstance(s, ErrorFeedbackStage):
                if remapped:
                    # Residual coordinates would belong to the PREVIOUS
                    # message's remapping (e.g. last round's top-k set) —
                    # compensation across mismatched coordinates silently
                    # corrupts every update.
                    raise WireError(
                        "ef must precede any coordinate-remapping stage "
                        "(topk/int8/hex); order the spec 'ef|topk|...'")
                ef_seen = True
            remapped = remapped or s.remaps_coordinates
            if ef_seen and s.delta_domain:
                # delta's decode intentionally stays in the delta domain
                # (not an encode-inverse), so a wrapping ef would compute
                # residual = comp - (comp - ref) = ref and re-inject the
                # whole reference model every message.
                raise WireError("ef cannot wrap delta; order the spec "
                                "'delta|ef|...' so the residual tracks "
                                "only what the lossy tail dropped")
        for s in stages[:-1]:
            if isinstance(s, CrcStage):
                # A later stage's decode need not reproduce the exact
                # bytes crc checksummed (int8 dequantizes, topk scatters),
                # so a non-terminal crc would fail every payload.
                raise WireError("crc must be the terminal stage (it "
                                "checksums the exact wire body)")
        self.stages = list(stages)
        self.self_describing = self_describing
        self.caps = PipelineCaps(self.stages)
        self.spec = "|".join(s.spec() for s in self.stages)

    def __repr__(self) -> str:
        mode = "wire" if self.self_describing else "legacy"
        return f"Pipeline({self.spec!r}, {mode})"

    @property
    def batchable(self) -> bool:
        """True when batch calls take the one-pass vectorized walk: a
        self-describing pipeline whose every stage ships vectorized batch
        twins.  Otherwise ``encode_batch``/``decode_batch`` still work but
        loop per item (legacy pipelines always loop — their wire format is
        the historical per-item one)."""
        return self.self_describing and all(s.batch_capable
                                            for s in self.stages)

    # -- state ---------------------------------------------------------------
    def new_state(self) -> PipelineState:
        return PipelineState(len(self.stages))

    def set_reference(self, state: PipelineState, vec: np.ndarray) -> None:
        """Prime every delta stage's reference (the model this endpoint
        last received); the orchestrator calls this at downlink time."""
        ref = np.ascontiguousarray(vec, dtype=np.float32)
        for i, s in enumerate(self.stages):
            if s.delta_domain:
                state.slots[i]["ref"] = ref

    def _state(self, state: Optional[PipelineState]) -> PipelineState:
        if state is None:
            return self.new_state()
        if len(state.slots) != len(self.stages):
            raise WireError(f"state has {len(state.slots)} slots, pipeline "
                            f"{self.spec!r} has {len(self.stages)} stages")
        return state

    # -- encode ---------------------------------------------------------------
    def encode(self, vec: np.ndarray,
               state: Optional[PipelineState] = None) -> bytes:
        """flat float32 vector -> wire bytes (headered unless legacy)."""
        state = self._state(state)
        vec = np.ascontiguousarray(vec, dtype=np.float32)
        if not self.self_describing:
            return self._encode_legacy(vec, state)
        arr = vec
        params: list[bytes] = []
        ef_marks: list[tuple[int, np.ndarray]] = []   # (index, compensated)
        for i, stage in enumerate(self.stages):
            if isinstance(stage, ErrorFeedbackStage):
                arr = stage.compensate(arr, state.slots[i])
                ef_marks.append((i, arr))
                params.append(b"")
                continue
            arr, p = stage.encode(arr, state.slots[i])
            params.append(p)
        # EF residual updates: decode each wrapped tail (deepest first) and
        # store comp - decoded.  Array-domain decode is numerically
        # identical to decoding the wire bytes (tobytes/frombuffer round-
        # trips exactly), so no second serialization happens.
        for i, comp in reversed(ef_marks):
            decoded = self._decode_tail(arr, params, i + 1, None)
            self.stages[i].update(comp, decoded, state.slots[i])
        header = WireHeader(self.spec, params, _body_dtype_code(arr.dtype))
        return header.pack() + np.ascontiguousarray(arr).tobytes()

    def encode_batch(self, vecs: Sequence[np.ndarray],
                     states: Optional[Sequence[Optional[PipelineState]]]
                     = None, *, device: _device.DeviceLike | None = None
                     ) -> list[bytes]:
        """Encode N same-length vectors in one vectorized stage walk.

        Returns the same bytes, in order, as ``[self.encode(v, s) for
        v, s in zip(vecs, states)]`` — byte-identical by contract — and
        mutates the per-item states exactly as the loop would (delta refs
        read, EF residuals written).  Falls back to that loop for legacy
        pipelines, non-:attr:`batchable` stage sets, or ragged input
        lengths, so it is always safe to call.  ``device`` overrides the
        package default for the ``int8`` kernels.
        """
        with _device.use_device(device):
            return self._encode_batch(vecs, states)

    def _encode_batch(self, vecs, states) -> list[bytes]:
        n_items = len(vecs)
        if states is None:
            states = [None] * n_items
        elif len(states) != n_items:
            raise WireError(f"encode_batch got {n_items} vectors but "
                            f"{len(states)} states")
        if n_items == 0:
            return []
        arrs = [np.ascontiguousarray(v, dtype=np.float32).reshape(-1)
                for v in vecs]
        if not self.batchable or len({a.size for a in arrs}) != 1:
            return [self.encode(a, s) for a, s in zip(arrs, states)]
        if (not self.caps.stateful and not self.caps.delta_domain
                and all(s is None for s in states)):
            # Stateless pipeline, no caller state: stages never write their
            # slots (the caps contract), so one shared scratch state serves
            # every item — skips N PipelineState allocations per call.
            states = [self.new_state()] * n_items
        else:
            states = [self._state(s) for s in states]
        chunk = _batch_chunk_rows(arrs[0].size)
        if n_items > chunk:
            out: list[bytes] = []
            for o in range(0, n_items, chunk):
                out.extend(self._encode_batch_walk(arrs[o:o + chunk],
                                                   states[o:o + chunk]))
            return out
        return self._encode_batch_walk(arrs, states)

    def _encode_batch_walk(self, arrs: Sequence[np.ndarray],
                           states: Sequence[PipelineState]) -> list[bytes]:
        """One vectorized stage walk over a (cache-sized) chunk of
        same-length vectors; see :meth:`encode_batch`."""
        n_items = len(arrs)
        batch = np.stack(arrs)
        slot_cols = [[st.slots[j] for st in states]
                     for j in range(len(self.stages))]
        arr = batch
        params_cols: list[Sequence[bytes]] = []
        ef_marks: list[tuple[int, np.ndarray]] = []
        for j, stage in enumerate(self.stages):
            if isinstance(stage, ErrorFeedbackStage):
                arr = stage.compensate_batch(arr, slot_cols[j])
                ef_marks.append((j, arr))
                params_cols.append([b""] * n_items)
                continue
            arr, p = stage.encode_batch(arr, slot_cols[j])
            if len(p) != n_items:
                raise WireError(f"stage {stage.spec()!r} returned {len(p)} "
                                f"params for {n_items} items")
            params_cols.append(p)
        for j, comp in reversed(ef_marks):
            decoded = self._decode_tail_batch(arr, params_cols, j + 1)
            self.stages[j].update_batch(comp, decoded, slot_cols[j])
        dtype_code = _body_dtype_code(arr.dtype)
        arr = np.ascontiguousarray(arr)
        n_st = len(self.stages)
        # Inline WireHeader.pack: the magic..n_stages prefix is shared by
        # the whole batch, so build it once and join per-item params +
        # body slices off bulk buffers (same bytes, no per-item objects).
        spec_b = self.spec.encode("utf-8")
        if len(spec_b) > 0xFFFF:
            raise WireError("pipeline spec too long")
        if n_st > 0xFF:
            raise WireError("too many stages")
        prefix = (WIRE_MAGIC + bytes([WIRE_VERSION]) + _U16.pack(len(spec_b))
                  + spec_b + bytes([dtype_code, n_st]))
        lens_cols = [[_U32.pack(len(p)) for p in col] for col in params_cols]
        body = arr.tobytes()
        row_b = arr.shape[1] * arr.itemsize if arr.ndim == 2 else 0
        out = []
        for i in range(n_items):
            parts = [prefix]
            for j in range(n_st):
                parts.append(lens_cols[j][i])
                parts.append(params_cols[j][i])
            parts.append(body[i * row_b:(i + 1) * row_b])
            out.append(b"".join(parts))
        return out

    def _encode_legacy(self, vec: np.ndarray, state: PipelineState) -> bytes:
        arr = vec
        ef_marks: list[tuple[int, np.ndarray]] = []
        for i, stage in enumerate(self.stages[:-1]):
            if isinstance(stage, ErrorFeedbackStage):
                arr = stage.compensate(arr, state.slots[i])
                ef_marks.append((i, arr))
                continue
            arr, p = stage.encode(arr, state.slots[i])
            if p:
                raise WireError(
                    f"stage {stage.spec()!r} emits wire params and cannot "
                    f"ride a legacy (headerless) pipeline mid-stream")
        terminal = self.stages[-1]
        data = terminal.legacy_encode(arr)
        if ef_marks:
            # The historical EF contract: residual against the terminal
            # codec's own decode of the just-encoded bytes.
            decoded = terminal.legacy_decode(data)
            for i, comp in reversed(ef_marks):
                # Transform stages between ef and the terminal are identity
                # on decode (delta) — the built-in legacy pipelines are
                # [delta?][ef?][codec], so decoded already matches comp's
                # domain.
                self.stages[i].update(comp, decoded, state.slots[i])
        return data

    # -- decode ---------------------------------------------------------------
    def _decode_tail(self, arr: np.ndarray, params: list[bytes],
                     start: int, state: Optional[PipelineState]
                     ) -> np.ndarray:
        for i in range(len(self.stages) - 1, start - 1, -1):
            slot = state.slots[i] if state is not None else {}
            try:
                arr = self.stages[i].decode(arr, params[i], slot)
            except (WireDecodeError, KernelError):
                raise
            except Exception as e:
                raise WireDecodeError(
                    f"stage {self.stages[i].spec()!r} failed to decode: "
                    f"{type(e).__name__}: {e}") from e
        return arr

    def decode(self, data: bytes,
               state: Optional[PipelineState] = None) -> np.ndarray:
        """wire bytes -> flat float32 vector.

        Self-describing pipelines parse their own header (and verify the
        header names *this* spec — use :func:`decode_payload` to honor
        whatever pipeline the sender chose).  Legacy pipelines decode the
        raw codec bytes.  All failures surface as WireDecodeError.
        """
        state = self._state(state)
        if not self.self_describing:
            try:
                arr = self.stages[-1].legacy_decode(data)
            except (WireError, KernelError):
                raise
            except Exception as e:
                raise WireDecodeError(
                    f"legacy payload undecodable under "
                    f"{self.stages[-1].spec()!r}: {type(e).__name__}: {e}"
                ) from e
            # Transform stages (delta/ef) are identity on decode; run them
            # anyway so third-party transform stages keep working here.
            for i in range(len(self.stages) - 2, -1, -1):
                arr = self.stages[i].decode(arr, b"", state.slots[i])
            return np.asarray(arr, dtype=np.float32)
        header, off = WireHeader.unpack(data)
        if header.spec != self.spec:
            raise WireDecodeError(
                f"header names pipeline {header.spec!r}, this pipeline is "
                f"{self.spec!r} (use decode_payload for negotiation)")
        return self._decode_body(header, data, off, state)

    def _decode_body(self, header: WireHeader, data: bytes, off: int,
                     state: Optional[PipelineState]) -> np.ndarray:
        if len(header.stage_params) != len(self.stages):
            raise WireDecodeError(
                f"header carries {len(header.stage_params)} stage params, "
                f"pipeline {self.spec!r} has {len(self.stages)} stages")
        dtype = np.dtype(_BODY_DTYPES[header.dtype_code])
        body = data[off:]
        if len(body) % dtype.itemsize:
            raise WireDecodeError(
                f"body length {len(body)} is not a multiple of "
                f"{dtype.itemsize}-byte {dtype} items")
        arr = np.frombuffer(body, dtype=dtype)
        vec = np.asarray(self._decode_tail(arr, header.stage_params, 0,
                                           state), dtype=np.float32)
        if not vec.flags.writeable:
            # Pass-through terminals (raw, bare delta) would hand back a
            # read-only view of the wire buffer; the codec contract has
            # always returned a writable array.
            vec = vec.copy()
        return vec

    # -- batch decode ---------------------------------------------------------
    def _decode_tail_batch(self, arr: np.ndarray,
                           params_cols: Sequence[Sequence[bytes]],
                           start: int) -> np.ndarray:
        """Batched :meth:`_decode_tail` over a rectangular group.  Decode
        is stateless for the built-ins, so every stage sees fresh empty
        slots (same as wire negotiation)."""
        n_items = arr.shape[0]
        for j in range(len(self.stages) - 1, start - 1, -1):
            # One shared dict: decode slots are read-only scratch for
            # correctly-declared stages (anything that writes decode state
            # must set PipelineCaps.stateful, which routes per-item).
            slots = [{}] * n_items
            try:
                arr = self.stages[j].decode_batch(arr, params_cols[j], slots)
            except (WireDecodeError, KernelError):
                raise
            except Exception as e:
                raise WireDecodeError(
                    f"stage {self.stages[j].spec()!r} failed to decode "
                    f"batch: {type(e).__name__}: {e}") from e
        return arr

    def _decode_body_batch(self, headers: Sequence[WireHeader],
                           datas: Sequence[bytes],
                           offs: Sequence[int]) -> np.ndarray:
        """Decode a *uniform* group (same spec, body dtype and body length
        — the grouping :func:`decode_payload_batch` performs) in one
        vectorized walk; returns the stacked ``(N, P)`` float32 matrix,
        bit-identical to per-item :meth:`_decode_body`.  Any malformation
        raises :class:`WireDecodeError`; the caller degrades to per-item
        decode to isolate the offending payload."""
        n_st = len(self.stages)
        for h in headers:
            if len(h.stage_params) != n_st:
                raise WireDecodeError(
                    f"header carries {len(h.stage_params)} stage params, "
                    f"pipeline {self.spec!r} has {n_st} stages")
        dtype = np.dtype(_BODY_DTYPES[headers[0].dtype_code])
        body_len = len(datas[0]) - offs[0]
        if body_len % dtype.itemsize:
            raise WireDecodeError(
                f"body length {body_len} is not a multiple of "
                f"{dtype.itemsize}-byte {dtype} items")
        count = body_len // dtype.itemsize
        chunk = _batch_chunk_rows(count)
        if len(datas) > chunk:
            parts = [self._decode_body_batch(headers[o:o + chunk],
                                             datas[o:o + chunk],
                                             offs[o:o + chunk])
                     for o in range(0, len(datas), chunk)]
            if any(m.shape[1] != parts[0].shape[1] for m in parts[1:]):
                # Uniform within each chunk but not across them (e.g.
                # mixed topk n values): same refusal as the stage-level
                # uniformity checks — degrade, don't guess a rectangle.
                raise WireDecodeError("batch group is not uniform")
            return np.concatenate(parts, axis=0)
        off0 = offs[0]
        if count <= 4096 and all(o == off0 for o in offs):
            # Small rows, same header length everywhere: one join + one
            # sliced copy beats N frombuffer calls' fixed overhead.
            buf = np.frombuffer(b"".join(datas), dtype=np.uint8)
            arr = np.ascontiguousarray(
                buf.reshape(len(datas), off0 + body_len)[:, off0:]
            ).view(dtype)
        else:
            # Large rows: copy overhead dominates call overhead, so fill
            # a preallocated matrix from zero-copy frombuffer views —
            # exactly one pass over the data.
            arr = np.empty((len(datas), count), dtype=dtype)
            for i, (d, off) in enumerate(zip(datas, offs)):
                arr[i] = np.frombuffer(d, dtype=dtype, count=count,
                                       offset=off)
        params_cols = [[h.stage_params[j] for h in headers]
                       for j in range(n_st)]
        mat = np.asarray(self._decode_tail_batch(arr, params_cols, 0),
                         dtype=np.float32)
        if not mat.flags.writeable:
            mat = mat.copy()
        return mat

    def decode_batch(self, datas: Sequence[bytes],
                     states: Optional[Sequence[Optional[PipelineState]]]
                     = None, *, device: _device.DeviceLike | None = None
                     ) -> np.ndarray:
        """Decode N payloads of *this* pipeline into a stacked ``(N, P)``
        float32 matrix, bit-identical to per-item :meth:`decode`.

        Strict: any malformed item raises :class:`WireDecodeError` (the
        server's per-item-degrading, negotiating entry point is
        :func:`decode_payload_batch`).  Falls back to a per-item loop for
        legacy pipelines, non-batchable stages, or a non-uniform group.
        ``device`` overrides the package default for the ``int8`` kernels.
        """
        with _device.use_device(device):
            return self._decode_batch(datas, states)

    def _decode_batch(self, datas, states) -> np.ndarray:
        datas = list(datas)
        if states is None:
            states = [None] * len(datas)
        if not datas:
            return np.zeros((0, 0), dtype=np.float32)
        if self.batchable:
            headers, offs = [], []
            for data in datas:
                header, off = WireHeader.unpack(data)
                if header.spec != self.spec:
                    raise WireDecodeError(
                        f"header names pipeline {header.spec!r}, this "
                        f"pipeline is {self.spec!r} (use "
                        f"decode_payload_batch for negotiation)")
                headers.append(header)
                offs.append(off)
            key0 = (headers[0].dtype_code, len(datas[0]) - offs[0])
            if all((h.dtype_code, len(d) - o) == key0
                   for h, d, o in zip(headers, datas, offs)):
                return self._decode_body_batch(headers, datas, offs)
        return _stack_rows([self.decode(d, s)
                            for d, s in zip(datas, states)], self.spec)


# --------------------------------------------------------------------------
# State migration across renegotiated pipeline swaps
# --------------------------------------------------------------------------
def migrate_state(old: Pipeline, old_state: Optional[PipelineState],
                  new: Pipeline) -> Optional[PipelineState]:
    """Carry encoder state across a live pipeline renegotiation
    (:mod:`repro_torch.core.control`), under the rules in ``docs/CONTROL.md``:

    * the first delta stage's reference (``slot["ref"]``) and the first
      ef stage's residual (``slot["residual"]``) carry over — both live
      in model coordinates (pipeline validation forces ef before any
      remapping stage), so they stay meaningful whatever the tail
      becomes;
    * everything else resets (a stage's private state is only defined
      under its own spec);
    * returns None when the new pipeline is stateless.

    The explicit-reset alternative (``ControlDecision.reset_state``) is
    simply not calling this and taking ``new.new_state()``.
    """
    if not new.caps.stateful:
        return None
    state = new.new_state()
    if old_state is None or len(old_state.slots) != len(old.stages):
        return state

    def _first(stages, pred):
        for i, s in enumerate(stages):
            if pred(s):
                return i
        return None

    for key, pred in (("ref", lambda s: s.delta_domain),
                      ("residual",
                       lambda s: isinstance(s, ErrorFeedbackStage))):
        i_old = _first(old.stages, pred)
        i_new = _first(new.stages, pred)
        if i_old is not None and i_new is not None:
            val = old_state.slots[i_old].get(key)
            if val is not None:
                state.slots[i_new][key] = val
    return state


# --------------------------------------------------------------------------
# Wire negotiation: decode from the header alone
# --------------------------------------------------------------------------
# Negotiation sits on the per-delivery hot path: memoize spec -> Pipeline
# (pipelines are immutable and state lives outside them, so sharing one
# instance across receivers is safe).  Invalidated implicitly by spec text;
# register_stage(..., overwrite=True) mid-run is the one case a stale entry
# could survive, so the cache is cleared there.  Size-capped because the
# keys are wire-supplied: a sender cycling through distinct parseable specs
# must not grow server memory without bound.
_NEGOTIATED: dict[str, Pipeline] = {}
_NEGOTIATED_CAP = 256


def _negotiated_pipeline(spec: str) -> Pipeline:
    """Memoized spec -> Pipeline for wire negotiation (see cache notes
    above); raises WireDecodeError for unparseable specs."""
    pipeline = _NEGOTIATED.get(spec)
    if pipeline is None:
        try:
            pipeline = parse_pipeline(spec)
        except WireError as e:
            raise WireDecodeError(
                f"header pipeline spec rejected: {e}") from e
        if len(_NEGOTIATED) >= _NEGOTIATED_CAP:
            _NEGOTIATED.clear()   # rare full reset beats unbounded growth
        _NEGOTIATED[spec] = pipeline
    return pipeline


def decode_payload(data: bytes,
                   state: Optional[PipelineState] = None
                   ) -> tuple[np.ndarray, Pipeline]:
    """Decode a self-describing payload with **zero out-of-band knowledge**:
    parse the header, rebuild the sender's pipeline from the stage
    registry, decode the body.  Returns ``(vector, pipeline)`` so the
    caller can branch on the negotiated ``pipeline.caps`` (e.g. aggregate
    in the delta domain).  Raises WireDecodeError for anything malformed,
    including spec tokens naming unregistered stages."""
    header, off = WireHeader.unpack(data)
    pipeline = _negotiated_pipeline(header.spec)
    if state is not None and len(state.slots) != len(pipeline.stages):
        state = None   # negotiated spec changed shape; decode is stateless
    vec = pipeline._decode_body(header, data, off, state)
    return vec, pipeline


def decode_payload_batch(datas: Sequence[bytes], *,
                         device: _device.DeviceLike | None = None) -> list[
        tuple[Optional[np.ndarray], Optional[Pipeline],
              Optional[WireDecodeError]]]:
    """Batched :func:`decode_payload` with **per-item degradation**.

    Returns one ``(vector, pipeline, error)`` triple per payload, in
    input order; exactly one of ``vector`` / ``error`` is None.  Payloads
    are grouped by (spec, body dtype, body length); each uniform group of
    a fully :attr:`Pipeline.batchable` pipeline decodes in one vectorized
    stage walk, bit-identical to the per-item path.  Anything else — a
    singleton, a non-batchable spec, or a group whose vectorized walk
    reports a malformation — degrades to per-item decode, so one corrupt
    payload zeroes out *that* client only and never poisons the batch.
    ``device`` overrides the package default for the ``int8`` kernels.
    """
    with _device.use_device(device):
        return _decode_payload_batch(datas)


def _decode_payload_batch(datas: Sequence[bytes]) -> list:
    results: list = [None] * len(datas)
    groups: dict[tuple, list] = {}
    # Fast header scan: payloads from one sender fleet share the entire
    # magic..spec..dtype..n_stages prefix, so after fully validating the
    # first header a byte-compare against that prefix lets the rest skip
    # straight to the per-stage params walk.  Any mismatch (or truncation
    # mid-walk) falls through to the full unpack for a proper error.
    fp_bytes = b""
    fp_len = fp_n_st = fp_dtype = fp_version = 0
    fp_spec, fp_pipeline = "", None
    for i, data in enumerate(datas):
        if fp_pipeline is not None and data[:fp_len] == fp_bytes:
            off, params, ok = fp_len, [], True
            for _ in range(fp_n_st):
                if len(data) < off + 4:
                    ok = False
                    break
                plen = _U32.unpack_from(data, off)[0]
                off += 4
                if len(data) < off + plen:
                    ok = False
                    break
                params.append(data[off:off + plen])
                off += plen
            if ok:
                header = WireHeader(fp_spec, params, fp_dtype, fp_version)
                key = (fp_spec, fp_dtype, len(data) - off)
                groups.setdefault(key, []).append(
                    (i, header, off, fp_pipeline))
                continue
        try:
            header, off = WireHeader.unpack(data)
            pipeline = _negotiated_pipeline(header.spec)
        except WireDecodeError as e:
            results[i] = (None, None, e)
            continue
        if fp_pipeline is None:
            # utf-8 re-encode reproduces the on-wire spec bytes exactly,
            # so the prefix length is recoverable from the parsed header.
            fp_len = 7 + len(header.spec.encode("utf-8"))
            fp_bytes = bytes(data[:fp_len])
            fp_n_st = len(header.stage_params)
            fp_dtype, fp_version = header.dtype_code, header.version
            fp_spec, fp_pipeline = header.spec, pipeline
        key = (header.spec, header.dtype_code, len(data) - off)
        groups.setdefault(key, []).append((i, header, off, pipeline))
    for members in groups.values():
        pipeline = members[0][3]
        if len(members) > 1 and pipeline.batchable:
            try:
                mat = pipeline._decode_body_batch(
                    [m[1] for m in members],
                    [datas[m[0]] for m in members],
                    [m[2] for m in members])
            except WireDecodeError:
                mat = None    # some item is malformed: isolate it below
            if mat is not None:
                for (i, _, _, _), row in zip(members, mat):
                    results[i] = (row, pipeline, None)
                continue
        for i, header, off, pipeline in members:
            try:
                vec = pipeline._decode_body(header, datas[i], off, None)
                results[i] = (vec, pipeline, None)
            except WireDecodeError as e:
                results[i] = (None, None, e)
    return results


# --------------------------------------------------------------------------
# Legacy bridge: TransportConfig(codec=...) -> headerless pipelines
# --------------------------------------------------------------------------
def legacy_pipeline(codec: str, codec_kwargs: Optional[dict] = None, *,
                    send_deltas: bool = False,
                    error_feedback: bool = False) -> Pipeline:
    """The pre-refactor wire behavior as a pipeline: ``[delta?][ef?][codec]``
    headerless.  EF is included only for lossy codecs — byte- and
    state-identical to the old hand-wired ``ServerCore.send_update`` path
    (pinned by the orchestrator-equivalence digests)."""
    kwargs = dict(codec_kwargs or {})
    if "(" in codec:
        if kwargs:
            raise WireError(
                f"codec {codec!r} embeds its args; passing codec_kwargs="
                f"{kwargs} too is ambiguous — use one or the other")
        terminal = parse_stage(codec)
    else:
        terminal = _terminal_from_name(codec, kwargs)
    stages: list[Stage] = []
    if send_deltas:
        stages.append(DeltaStage())
    if error_feedback and not terminal.lossless:
        stages.append(ErrorFeedbackStage())
    stages.append(terminal)
    return Pipeline(stages, self_describing=False)


class CodecStage(Stage):
    """Adapter: any legacy :class:`repro_torch.core.compression.Codec` instance
    as a terminal stage.  Headered mode ships the codec's own bytes as a
    uint8 body; wire negotiation of a CodecStage requires its name to be
    registered (the four built-ins map to canonical stages instead)."""

    def __init__(self, codec):
        self.codec = codec
        self.name = codec.name
        self.lossless = codec.lossless
        self.legacy_codec = codec

    def encode(self, arr, slot):
        arr = _require_f4(arr, self.name)
        return np.frombuffer(self.codec.encode(arr), dtype=np.uint8), b""

    def decode(self, arr, params, slot):
        data = np.ascontiguousarray(arr, dtype=np.uint8).tobytes()
        try:
            return np.asarray(self.codec.decode(data), dtype=np.float32)
        except Exception as e:
            raise WireDecodeError(f"codec {self.name!r} failed to decode: "
                                  f"{type(e).__name__}: {e}") from e


def stage_for_codec(codec) -> Stage:
    """Map a legacy Codec instance onto its canonical stage (the four
    built-ins) or a :class:`CodecStage` adapter (anything else)."""
    if isinstance(codec, RawCodec):
        return RawStage()
    if isinstance(codec, HexCodec):
        return HexStage()
    if isinstance(codec, Int8Codec):
        return Int8Stage(block=codec.block)
    if isinstance(codec, TopKCodec):
        return TopKStage(codec.k_fraction)
    return CodecStage(codec)


def _terminal_from_name(codec: str, kwargs: dict) -> Stage:
    # Codec kwargs use the compression.py names; map them onto stage args.
    if codec == "int8":
        return Int8Stage(**kwargs)
    if codec == "topk":
        if "k_fraction" in kwargs:
            return TopKStage(kwargs["k_fraction"])
        return TopKStage(**kwargs)
    if kwargs:
        raise WireError(f"codec {codec!r} takes no kwargs, got {kwargs}")
    return parse_stage(codec)


register_stage("delta", DeltaStage)
register_stage("ef", ErrorFeedbackStage)
register_stage("topk", TopKStage)
register_stage("int8", Int8Stage)
register_stage("raw", RawStage)
register_stage("hex", HexStage)
register_stage("crc", CrcStage)
