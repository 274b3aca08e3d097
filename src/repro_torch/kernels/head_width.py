"""Run a kernel compiled for a few head widths at any width up to the
largest: q, k and v are zero-padded along the head dimension to the next
compiled width, the scale of the true width is passed on, and the output
is sliced back.

The padding is exact for attention and the mLSTM alike: a zero column
adds nothing to any ``q . k``, so the scores, the softmax and the mLSTM
normaliser (a sum of gated scores) are those of the true width, and the
padded columns of ``v`` give output columns that are dropped.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def kernel_width(hd: int, widths: tuple[int, ...], what: str) -> int:
    """The smallest compiled width in ``widths`` that holds ``hd``."""
    for width in sorted(widths):
        if 0 < hd <= width:
            return width
    raise ValueError(f"the {what} kernel takes head widths up to "
                     f"{max(widths)} (compiled at {widths}); got {hd}")


def run_padded(fn: Callable, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor, *rest, widths: tuple[int, ...], what: str,
               **kw) -> torch.Tensor:
    """``fn(q, k, v, *rest, scale=hd ** -0.5, **kw)`` with q, k, v padded
    to :func:`kernel_width` and the output cut back to ``hd`` columns."""
    hd = q.shape[-1]
    width = kernel_width(hd, widths, what)
    if width != hd:
        q, k, v = (F.pad(t, (0, width - hd)) for t in (q, k, v))
    out = fn(q, k, v, *rest, scale=hd ** -0.5, **kw)
    return out if width == hd else out[..., :hd].contiguous()
