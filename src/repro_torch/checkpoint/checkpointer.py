"""Checkpointing: self-contained leaf container, atomic writes, retention
(the reference's ``repro.checkpoint.checkpointer``, for trees of tensors).

Tree leaves are serialized path-keyed (shape/dtype-tagged raw bytes,
compressed per leaf), so a restore can place them on any device: the
template controls placement, the file stores only bytes.  Writes are
atomic (tmp + fsync + rename) so a crash mid-save never corrupts the
latest checkpoint; that plus the FL journal gives the crash-restart story.

The container is the reference's, byte for byte, so each package reads
the other's files::

    magic "FLCK" | version u8 | codec u8 | manifest_len u32 LE
    manifest JSON: {"metadata": ..., "leaves": [{name, shape, dtype,
                                                 offset, size}, ...]}
    body: concatenated compressed leaf blobs

Leaves are walked in JAX's pytree order and named as the reference names
them: dict keys sorted, list and tuple items by index, a NamedTuple's
items (``TrainState``) by field name, ``None`` an empty subtree; names
join with ``/``.  A bfloat16 leaf is stored under the tag ``"bfloat16"``
as its raw 16-bit patterns.

``codec`` names the compressor per *file*: zlib (always available) or
zstd (used for writes when the ``zstandard`` package imports).  A reader
that lacks zstd fails with an explicit error naming the gap.  Leaves are
compressed and decompressed on a thread pool (zlib and zstd release the
GIL); each blob is the same single-call compression as the reference's,
so the bytes do not depend on the pool.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import struct
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.tree import named_leaves, rebuild

try:
    import zstandard as _zstd
except ImportError:          # optional: zlib is the floor, not a stub
    _zstd = None

_MAGIC = b"FLCK"
_VERSION = 2
_CODEC_ZLIB = 0
_CODEC_ZSTD = 1
_HEADER = struct.Struct("<4sBBI")     # magic, version, codec, manifest_len


def _compress(codec: int, raw: bytes) -> bytes:
    if codec == _CODEC_ZSTD:
        return _zstd.ZstdCompressor(level=3).compress(raw)
    return zlib.compress(raw, 6)


def _decompress(codec: int, blob: bytes) -> bytes:
    if codec == _CODEC_ZSTD:
        if _zstd is None:
            raise RuntimeError(
                "this checkpoint was written with zstd compression but the "
                "'zstandard' package is not importable here; install it or "
                "re-save the checkpoint from a zlib-only environment")
        return _zstd.ZstdDecompressor().decompress(blob)
    if codec == _CODEC_ZLIB:
        return zlib.decompress(blob)
    raise ValueError(f"unknown checkpoint codec id {codec}")


def _workers(n: int) -> int:
    return max(1, min(n, os.cpu_count() or 1))


def _leaf_bytes(leaf: Any) -> tuple[bytes, list, str]:
    """(raw bytes, shape, dtype tag) of one leaf, as the reference's
    ``np.asarray(leaf)`` gives them."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return (t.view(torch.int16).numpy().tobytes(), list(t.shape),
                    "bfloat16")
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr.tobytes(), list(arr.shape), str(arr.dtype)


def _leaf_tensor(buf: bytes, rec: dict) -> torch.Tensor:
    """The CPU tensor a manifest record describes."""
    if rec["dtype"] == "bfloat16":
        arr = np.frombuffer(buf, dtype=np.int16).reshape(rec["shape"])
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    arr = np.frombuffer(buf, dtype=np.dtype(rec["dtype"]))
    return torch.from_numpy(arr.reshape(rec["shape"]).copy())


def _like(t: torch.Tensor, leaf: Any) -> Any:
    """``t`` in the template leaf's kind: a tensor on its device, or a
    numpy array (bfloat16 as ``ml_dtypes.bfloat16`` when installed)."""
    if isinstance(leaf, torch.Tensor):
        return t.to(leaf.device)
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().view(np.uint16)
        try:
            import ml_dtypes
        except ImportError:
            return bits
        return bits.view(ml_dtypes.bfloat16)
    return t.numpy()


# --------------------------------------------------------------------------
# Container
# --------------------------------------------------------------------------
def save_pytree(path: str, tree: Any, metadata: Optional[dict] = None
                ) -> None:
    codec = _CODEC_ZSTD if _zstd is not None else _CODEC_ZLIB
    flat = list(named_leaves(tree))

    def encode(item):
        name, leaf = item
        raw, shape, dtype = _leaf_bytes(leaf)
        return name, shape, dtype, _compress(codec, raw)

    with concurrent.futures.ThreadPoolExecutor(_workers(len(flat))) as pool:
        encoded = list(pool.map(encode, flat))
    leaves, offset = [], 0
    for name, shape, dtype, blob in encoded:
        leaves.append({"name": name, "shape": shape, "dtype": dtype,
                       "offset": offset, "size": len(blob)})
        offset += len(blob)
    manifest = json.dumps({"metadata": metadata or {},
                           "leaves": leaves}).encode("utf-8")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_HEADER.pack(_MAGIC, _VERSION, codec, len(manifest)))
        f.write(manifest)
        for *_, blob in encoded:
            f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)   # atomic


def load_pytree(path: str, template: Optional[Any] = None, *,
                device: _device.DeviceLike | None = None
                ) -> tuple[Any, dict]:
    """``(tree, metadata)``.  With a ``template``, the tree has its
    structure and each leaf its kind (a tensor on the template leaf's
    device, or a numpy array), in the stored dtype.  Without one, a
    nested dict rebuilt from the leaf names, of tensors on ``device``
    (the package default when None)."""
    with open(path, "rb") as f:
        head = f.read(_HEADER.size)
        if len(head) < _HEADER.size:
            raise ValueError(f"{path}: truncated checkpoint header")
        magic, version, codec, manifest_len = _HEADER.unpack(head)
        if magic != _MAGIC:
            raise ValueError(f"{path}: not a checkpoint file "
                             f"(magic {magic!r})")
        if version != _VERSION:
            raise ValueError(f"{path}: unsupported checkpoint version "
                             f"{version} (expected {_VERSION})")
        manifest = json.loads(f.read(manifest_len).decode("utf-8"))
        body = f.read()
    records = {rec["name"]: rec for rec in manifest["leaves"]}

    def read_all(names: list[str]) -> list[torch.Tensor]:
        def read(name):
            rec = records[name]
            blob = body[rec["offset"]:rec["offset"] + rec["size"]]
            return _leaf_tensor(_decompress(codec, blob), rec)
        with concurrent.futures.ThreadPoolExecutor(
                _workers(len(names))) as pool:
            return list(pool.map(read, names))

    if template is None:
        dev = _device.resolve(device)
        names = list(records)
        out: dict = {}
        for name, t in zip(names, read_all(names)):
            parts = name.split("/")
            cur = out
            for p in parts[:-1]:
                cur = cur.setdefault(p, {})
            cur[parts[-1]] = t.to(dev)
        return out, manifest["metadata"]

    flat = list(named_leaves(template))
    for name, _ in flat:
        if name not in records:
            raise KeyError(f"checkpoint missing leaf {name}")
    vals = []
    for (name, leaf), t in zip(flat, read_all([n for n, _ in flat])):
        want = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) \
            else tuple(np.shape(leaf))
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != template "
                             f"{want}")
        vals.append(_like(t, leaf))
    return rebuild(template, iter(vals)), manifest["metadata"]


class CheckpointManager:
    """step-indexed directory of checkpoints with retention."""

    SUFFIX = ".ckpt"

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _file(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:010d}{self.SUFFIX}")

    def save(self, step: int, tree: Any, metadata: Optional[dict] = None
             ) -> str:
        meta = dict(metadata or {}, step=step)
        path = self._file(step)
        save_pytree(path, tree, meta)
        self._gc()
        return path

    def steps(self) -> list[int]:
        out = []
        for f in os.listdir(self.dir):
            if f.startswith("ckpt_") and f.endswith(self.SUFFIX):
                out.append(int(f[5:15]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, template: Any, step: Optional[int] = None
                ) -> tuple[Any, dict]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return load_pytree(self._file(step), template)

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep]:
            os.remove(self._file(s))
