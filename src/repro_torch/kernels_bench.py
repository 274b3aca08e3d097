"""The hand-written kernels against their plain PyTorch versions, at the
reference's kernel-benchmark shapes.

The counterpart of the reference's ``benchmarks/kernels_bench.py``, which
times each Pallas kernel (in interpret mode) against its jnp oracle.  The
same five pairs, at the reference's shapes and dtypes, on inputs drawn
from ``default_rng(0)`` in the reference's order (:func:`inputs`):

* fedavg over a (4, 262,144) float32 stack;
* quantize of (64, 1024) float32 in blocks of 1024;
* ChunkSum-32 over 262,144 byte values;
* flash attention in float32, B 1, H 2, S 512, hd 64, causal (the
  reference's (B, H, S, hd) draws, transposed to the port's (B, S, H, hd));
* the mLSTM in float32 at (1, 256, 2, 64).

Each pair gives two rows, ``kernels/<name>_kernel`` (the reference's
``_pallas``: the wrapper, which launches the CUDA kernel on the card and
runs the plain version on the CPU) and ``kernels/<name>_ref`` (the plain
version).  Each is timed as the reference times its pair: one warm call,
then the mean of 2 calls (1 for flash attention and the mLSTM), each
ending in ``torch.cuda.synchronize()`` on the card.  The kernel row's
derived fields are the reference's (``max_dev=``, ``scale_dev=``,
``match=``, ``;S=512``), then ``;route=cuda`` where the wrapper launched
its kernel and ``;route=plain`` where it did not.

Each kernel row also holds the contract the port pins: fedavg, quantize
and the checksum bit for bit against the plain version, flash attention
and the mLSTM within :data:`BANDS` (``|got - want| <= band * (1 +
|want|)``).  A broken contract raises
:class:`repro_torch.kernels.KernelError`, so the harness prints the
suite's error row and exits 1.

    PYTHONPATH=src python -m repro_torch.bench_run --device cpu --only kernels
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch import kernels
from repro_torch.kernels import KernelError
from repro_torch.kernels.checksum import ops as checksum_ops
from repro_torch.kernels.checksum import ref as checksum_ref
from repro_torch.kernels.fedavg import ops as fedavg_ops
from repro_torch.kernels.fedavg import ref as fedavg_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.mlstm import ops as mlstm_ops
from repro_torch.kernels.mlstm import ref as mlstm_ref
from repro_torch.kernels.quantize import ops as quant_ops
from repro_torch.kernels.quantize import ref as quant_ref

QBLOCK = 1024
FLASH_SHAPE = (1, 2, 512, 64)          # the reference's (B, H, S, hd)
MLSTM_SHAPE = (1, 256, 2, 64)          # (B, S, nh, dh)
#: The float32 bands of flash attention and the mLSTM, as the port's
#: kernel tests and ``chip_smoke.py`` hold them.
BANDS = {"flash_attention": 2e-5, "mlstm": 5e-4}


def inputs() -> dict[str, tuple[np.ndarray, ...]]:
    """The reference's draws, in its order and its layouts, by kernel."""
    rng = np.random.default_rng(0)
    out = {"fedavg": (rng.standard_normal((4, 262_144)).astype(np.float32),
                      np.asarray([0.1, 0.2, 0.3, 0.4], np.float32)),
           "quantize": (rng.standard_normal((64, QBLOCK)).astype(
               np.float32),),
           "checksum": (rng.integers(0, 256, 262_144).astype(np.int32),)}
    out["flash_attention"] = tuple(
        rng.standard_normal(FLASH_SHAPE).astype(np.float32)
        for _ in range(3))
    B, S, nh, dh = MLSTM_SHAPE
    qkv = tuple(rng.standard_normal(MLSTM_SHAPE).astype(np.float32)
                for _ in range(3))
    ig = rng.standard_normal((B, S, nh)).astype(np.float32)
    fg = (rng.standard_normal((B, S, nh)) + 1).astype(np.float32)
    out["mlstm"] = (*qkv, ig, fg)
    return out


def port_args(name: str, arrays: tuple[np.ndarray, ...],
              dev: torch.device) -> tuple[torch.Tensor, ...]:
    """One kernel's inputs in the port's layouts and dtypes on ``dev``."""
    if name == "checksum":
        return (torch.from_numpy(arrays[0].astype(np.uint8)).to(dev),)
    if name == "flash_attention":      # (B, H, S, hd) -> (B, S, H, hd)
        return tuple(torch.from_numpy(a).transpose(1, 2).contiguous().to(dev)
                     for a in arrays)
    return tuple(torch.from_numpy(a).to(dev) for a in arrays)


#: kernel name -> (wrapper, plain version, timed calls); each wrapper is
#: looked up in its module at the call, so a caller may wrap it there.
PAIRS = {
    "fedavg": (lambda s, w: fedavg_ops.fedavg(s, w), fedavg_ref.fedavg, 2),
    "quantize": (lambda x: quant_ops.quantize(x, QBLOCK),
                 lambda x: quant_ref.quantize(x, QBLOCK), 2),
    "checksum": (lambda x: checksum_ops.chunksum32(x),
                 checksum_ref.chunksum32, 2),
    "flash_attention": (lambda q, k, v: flash_ops.flash_attention(q, k, v),
                        flash_ref.flash_attention, 1),
    "mlstm": (lambda *a: mlstm_ops.mlstm(*a), mlstm_ref.mlstm_parallel, 1),
}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def compare(name: str, got, want) -> tuple[str, bool]:
    """The kernel row's reference fields, and whether its contract
    holds."""
    if name == "quantize":
        dev = float((got[1] - want[1]).abs().max())
        return (f"scale_dev={dev:.2e}",
                all(torch.equal(_bits(g), _bits(w))
                    for g, w in zip(got, want)))
    if name == "checksum":
        match = checksum_ref.combine(got) == checksum_ref.combine(want)
        return f"match={match}", match and torch.equal(got, want)
    d = (got - want).abs()
    derived = f"max_dev={float(d.max()):.2e}"
    if name == "fedavg":
        return derived, torch.equal(_bits(got), _bits(want))
    held = bool((d <= BANDS[name] * (1 + want.abs())).all())
    if name == "flash_attention":
        derived += f";S={FLASH_SHAPE[2]}"
    return derived, held


def _time(fn, args, reps: int, dev: torch.device):
    def call():
        out = fn(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out
    out = call()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = call()
    return (time.perf_counter() - t0) * 1e6 / reps, out


def bench():
    """``(row name, wall us, derived fields)``, as the reference's
    ``bench()``, its ``_pallas`` rows renamed ``_kernel``."""
    dev = _device.resolve()
    rows = []
    for name, arrays in inputs().items():
        wrapper, plain, reps = PAIRS[name]
        args = port_args(name, arrays, dev)
        before = kernels.launch_counts[name]
        us_k, got = _time(wrapper, args, reps, dev)
        route = "cuda" if kernels.launch_counts[name] > before else "plain"
        us_r, want = _time(plain, args, reps, dev)
        derived, held = compare(name, got, want)
        if not held:
            raise KernelError(f"{name}: the {route} route disagrees with the "
                              f"plain version ({derived})")
        rows.append((f"kernels/{name}_kernel", us_k,
                     f"{derived};route={route}"))
        rows.append((f"kernels/{name}_ref", us_r, "oracle"))
    return rows
