"""Learning-rate schedules (pure functions of the step counter), the
reference's ``repro.optim.schedules``.

Each takes the step (an int or an integer tensor) and returns a 0-d
float32 tensor on the step's device.  The value is computed on the host
in float32, operation for operation as the reference's traced function
computes it; the cosine is the C library's ``cosf``, which is what the
reference's CPU backend calls (PyTorch's float32 cosine differs from it
in the last bit for about 5% of arguments), so the two packages give the
same bits.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import math

import numpy as np
import torch

_LIBM = ctypes.CDLL(ctypes.util.find_library("m"))
_LIBM.cosf.restype = ctypes.c_float
_LIBM.cosf.argtypes = [ctypes.c_float]

f32 = np.float32


def _host_step(step) -> tuple[np.float32, torch.device]:
    if isinstance(step, torch.Tensor):
        return f32(int(step)), step.device
    return f32(int(step)), torch.device("cpu")


def _out(value: np.float32, dev: torch.device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=dev)


def constant(lr: float):
    def fn(step):
        return _out(f32(lr), _host_step(step)[1])
    return fn


def linear_warmup(lr: float, warmup_steps: int):
    def fn(step):
        s, dev = _host_step(step)
        frac = np.minimum(s / f32(max(warmup_steps, 1)), f32(1.0))
        return _out(f32(lr) * frac, dev)
    return fn


def cosine_schedule(lr: float, warmup_steps: int, total_steps: int,
                    final_fraction: float = 0.1):
    def fn(step):
        s, dev = _host_step(step)
        warm = np.minimum(s / f32(max(warmup_steps, 1)), f32(1.0))
        prog = (s - f32(warmup_steps)) / f32(max(total_steps - warmup_steps,
                                                  1))
        prog = np.minimum(f32(1.0), np.maximum(prog, f32(0.0)))
        c = f32(_LIBM.cosf(float(f32(math.pi) * prog)))
        cos = f32(final_fraction) + f32((1 - final_fraction) * 0.5) * (
            f32(1.0) + c)
        return _out(f32(lr) * warm * cos, dev)
    return fn
