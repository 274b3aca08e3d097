"""Carry model weights between the reference's pytrees and the port.

A reference parameter tree here is a dict of numpy arrays (what the
reference's models return from ``init_params`` and what travels over the
wire).  The port holds the same weights as a dict of tensors on a device
plus a *layout*: the ``(key, shape)`` list in the reference's flat order,
dict keys **sorted** (JAX's pytree order, which every wire byte follows).

Model trees (the LM side) are nested dicts whose leaves keep their dtype
and the reference's stacked-by-layer shapes (a leading ``(L, ...)`` or
``(G, M, ...)`` axis), which the port's models index the same way:
:func:`tree_from_reference` and :func:`tree_to_reference` carry them
across both ways, bit for bit.  A bfloat16 leaf travels as its raw 16-bit
pattern (numpy has no bfloat16 of its own).
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


def _leaf_from_reference(leaf: Any, dev: torch.device) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":          # ml_dtypes.bfloat16
        bits = np.ascontiguousarray(arr).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(arr, copy=True)).to(dev)


def tree_from_reference(tree: Any,
                        device: _device.DeviceLike | None = None) -> Any:
    """A reference parameter tree (nested dicts of arrays, e.g. from
    ``repro.models.model.init``) -> the same tree of tensors on ``device``
    (default: the package default), dtypes and shapes kept."""
    dev = _device.resolve(device)
    if isinstance(tree, dict):
        return {key: tree_from_reference(val, dev) for key, val in
                tree.items()}
    return _leaf_from_reference(tree, dev)


def tree_to_reference(tree: Any) -> Any:
    """A port tree of tensors -> nested dicts of numpy arrays, dtypes kept;
    bfloat16 leaves come back as ``ml_dtypes.bfloat16`` arrays when
    ``ml_dtypes`` is installed, else as their raw ``uint16`` bits."""
    if isinstance(tree, dict):
        return {key: tree_to_reference(val) for key, val in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().view(np.uint16)
        try:
            import ml_dtypes
        except ImportError:
            return bits
        return bits.view(ml_dtypes.bfloat16)
    return t.numpy()
