"""The port's one default device, and the explicit override.

Every entry point of :mod:`repro_torch` runs on ``cuda`` unless its caller
names another device, either with the entry point's own ``device=``
argument or by wrapping the call in :func:`use_device`.  Nothing here
probes for a card and falls back: asking for ``cuda`` on a machine
without one raises, so a run can never silently measure the CPU.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch

DeviceLike = Union[str, torch.device]

_DEFAULT: torch.device = torch.device("cuda")


def resolve(device: Optional[DeviceLike] = None) -> torch.device:
    """``device`` if given, else the package default; raises for ``cuda``
    when ``torch.cuda.is_available()`` is False."""
    dev = _DEFAULT if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is "
            f"False; run on a CUDA machine or pass device='cpu' / wrap the "
            f"call in repro_torch.device.use_device('cpu')")
    return dev


def default_device() -> torch.device:
    """The package default (unvalidated: it may name an absent card)."""
    return _DEFAULT


@contextlib.contextmanager
def use_device(device: Optional[DeviceLike]) -> Iterator[torch.device]:
    """Make ``device`` the package default inside the block.  ``None``
    keeps the current default, so entry points can wrap their body in
    ``use_device(device)`` for an optional ``device=`` argument.  The
    device is checked where a tensor is placed on it (:func:`resolve`),
    so a block that never touches a tensor runs anywhere."""
    global _DEFAULT
    prev = _DEFAULT
    if device is not None:
        _DEFAULT = torch.device(device)
    try:
        yield _DEFAULT
    finally:
        _DEFAULT = prev
