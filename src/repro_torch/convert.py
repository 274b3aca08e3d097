"""Carry model weights between the reference's pytrees and the port.

A reference parameter tree here is a dict of numpy arrays (what the
reference's models return from ``init_params`` and what travels over the
wire).  The port holds the same weights as a dict of tensors on a device
plus a *layout*: the ``(key, shape)`` list in the reference's flat order,
dict keys **sorted** (JAX's pytree order, which every wire byte follows).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import device as _device

Layout = list[tuple[str, tuple[int, ...]]]


def layout_of(tree: dict[str, Any]) -> Layout:
    """The flat layout of a dict of arrays, in sorted-key order."""
    if not isinstance(tree, dict):
        raise TypeError(f"expected a dict of arrays, got {type(tree)}")
    for key, leaf in tree.items():
        if isinstance(leaf, (dict, list, tuple)):
            raise TypeError(f"parameter {key!r} is a nested container; "
                            f"only flat dicts of arrays are supported")
    return [(key, tuple(np.shape(tree[key]))) for key in sorted(tree)]


def from_reference(tree: dict[str, Any],
                   device: _device.DeviceLike | None = None
                   ) -> tuple[dict[str, torch.Tensor], Layout]:
    """Reference parameter dict (numpy) -> (float32 tensors on ``device``,
    layout).  ``device`` defaults to the package default."""
    dev = _device.resolve(device)
    layout = layout_of(tree)
    params = {key: torch.tensor(np.asarray(tree[key], dtype=np.float32),
                                device=dev)
              for key, _ in layout}
    return params, layout


def to_reference(params: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Port params -> the reference's dict of float32 numpy arrays."""
    return {key: params[key].detach().to("cpu", torch.float32).numpy()
            for key in sorted(params)}


def flatten(params: dict[str, torch.Tensor], layout: Layout) -> torch.Tensor:
    """Concatenate ``params`` in layout order into one flat tensor."""
    return torch.cat([params[key].reshape(-1) for key, _ in layout])


def unflatten(vec: torch.Tensor, layout: Layout) -> dict[str, torch.Tensor]:
    """Split a flat tensor into layout-shaped views."""
    out, off = {}, 0
    for key, shape in layout:
        n = int(np.prod(shape)) if shape else 1
        out[key] = vec[off:off + n].view(shape)
        off += n
    if off != vec.numel():
        raise ValueError(f"vector has {vec.numel()} params, layout needs "
                         f"{off}")
    return out
