"""Loop-aware FLOPs, bytes and peak memory of a traced step: what the
reference's ``repro.launch.hlo_cost`` computes from XLA's HLO text, taken
here from the ops a PyTorch program dispatches.

A torch program produces no HLO, so nothing is parsed: :class:`Tally` is a
``TorchDispatchMode`` that sees every aten op of a step run on the
``meta`` device (no memory, no arithmetic) and keeps

  * ``flops``: the dot ops' FLOPs (``torch.utils.flop_counter``'s
    formulas: ``2 * M * N * K`` a matmul), as ``hlo_cost`` counts dots;
  * ``bytes``: each op's operands plus its results (views and bare
    allocations free), the reference's per-instruction upper bound
    (``hlo_bytes``);
  * ``peak``: the most bytes alive at once, each storage counted from the
    op that makes it until the last tensor on it is freed.

An eager Python loop over layers is counted once per iteration by
construction.  Loops whose iterations repeat the same ops on the same
shapes (the sLSTM's time steps, the MoE's experts, the microbatches of a
train step) go through :func:`steps`: under a tally it traces three
iterations and counts the middle one for those not traced, as
``hlo_cost`` multiplies a ``while`` body by its trip count; ``raw_flops``
counts each such body once (the counterpart of XLA's
``cost_analysis()``).  Where the body's backward runs after the loop, the
middle iteration's autograd nodes count for the untraced ones too, and
the bytes it keeps alive stand in for theirs until its backward starts.
Outside a tally :func:`steps` is ``range``.
"""

from __future__ import annotations

import threading
import weakref
from typing import Iterator, Optional

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

_STATE = threading.local()


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _is_view(func) -> bool:
    """An op whose every result aliases an operand without writing it
    (``view``, ``transpose``, ``expand``, ``select``, ...): no traffic."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


#: ops that allocate without touching memory: no traffic
_ALLOCATIONS = {torch.ops.aten.empty, torch.ops.aten.empty_strided,
                torch.ops.aten.empty_like, torch.ops.aten.new_empty,
                torch.ops.aten.new_empty_strided}


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Tally(TorchDispatchMode):
    """FLOPs, bytes and live / peak bytes of the ops dispatched inside
    ``with Tally() as tally:`` (see the module docstring).  :meth:`hold`
    registers tensors made before it (a step's arguments) as live."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0
        self.raw_flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._storages: dict[int, weakref.ref] = {}
        # traced loops whose backward is still to come: [first and last
        # autograd sequence number of the second iteration's nodes, the
        # count each of them stands for, the bytes held for the untraced
        # iterations]
        self._loops: list[list] = []

    def hold(self, *trees) -> int:
        """Count the storages of ``trees``' tensors as live; returns the
        bytes newly counted."""
        before = self.live
        for t in _tensors(trees):
            self._track(t)
        return self.live - before

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes()

        def freed(_ref, key=key, n=n):
            self._storages.pop(key, None)
            self.live -= n
        self._storages[key] = weakref.ref(st, freed)
        self.live += n
        self.peak = max(self.peak, self.live)

    def _repeats(self) -> int:
        """How many iterations the running backward node stands for.  The
        first backward op at a traced loop's nodes or older ones releases
        the bytes held for its untraced iterations (a checkpoint's
        recompute of the loop: the first after the recompute, whose nodes
        never run)."""
        # a backward formula runs with autograd off; a checkpoint's
        # recompute, which a node's evaluation may start, with it on
        node = (torch._C._current_autograd_node()
                if self._loops and not torch.is_grad_enabled() else None)
        if node is None:
            return 1
        seq, k = node._sequence_nr(), 1
        for loop in self._loops:
            if seq <= loop[1]:
                self.live -= loop[3]
                loop[3] = 0
                if loop[0] <= seq:
                    k *= loop[2]
        return k

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _is_view(func):
            return out
        k = self._repeats()
        results = _tensors(out)
        if func._overloadpacket not in _ALLOCATIONS:
            self.bytes += k * sum(nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += k * sum(nbytes(t) for t in results)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            f = int(count(*args, **kwargs, out_val=out))
            self.flops += k * f
            self.raw_flops += f
        for t in results:
            self._track(t)
        return out

    def __enter__(self):
        self._outer = getattr(_STATE, "tally", None)
        _STATE.tally = self
        return super().__enter__()

    def __exit__(self, *exc):
        _STATE.tally = self._outer
        return super().__exit__(*exc)


def active() -> Optional[Tally]:
    """The tally tracing the current step, if any."""
    return getattr(_STATE, "tally", None)


def _next_sequence_nr() -> int:
    """The autograd sequence number of the next node made on this thread
    (a probe node, made outside the tally)."""
    with _disable_current_modes():
        probe = torch.ones((), requires_grad=True) * 1.0
    return probe.grad_fn._sequence_nr() + 1


def steps(n: int, *, closed: bool = False) -> Iterator[int]:
    """``range(n)`` for a loop whose iterations run the same ops on the
    same shapes.  Under a :class:`Tally` it yields 0, 1 and 2 alone and
    counts the middle one, the steady state (the one before it still
    holds its locals, the one after it adds into its gradients), for the
    ``n - 3`` not traced.  With autograd on and the body's backward left
    for later (not ``closed``: a microbatch takes its own gradient
    inside), the middle iteration's backward counts ``n - 2`` times as
    well, and the bytes it keeps alive are held ``n - 3`` times more
    until that backward starts.  The middle iteration is counted before
    the last one runs, so a checkpoint's recompute, which stops at its
    region's last saved tensor (in the last iteration), counts in full.
    ``raw_flops`` counts the body once."""
    tally = active()
    if tally is None or n <= 3:
        yield from range(n)
        return
    later = torch.is_grad_enabled() and not closed
    yield 0
    flops, nbytes_, raw = tally.flops, tally.bytes, tally.raw_flops
    live, first = tally.live, _next_sequence_nr() if later else 0
    yield 1
    tally.flops += (n - 3) * (tally.flops - flops)
    tally.bytes += (n - 3) * (tally.bytes - nbytes_)
    if later:
        held = (n - 3) * max(0, tally.live - live)
        tally.live += held
        tally.peak = max(tally.peak, tally.live)
        tally._loops.append([first, _next_sequence_nr() - 1, n - 2, held])
    yield 2
    tally.raw_flops = raw


def stack_steps(ys: list, n: int, dim: int = 0) -> torch.Tensor:
    """``torch.stack(ys, dim)`` of the ``n`` per-iteration results of a
    :func:`steps` loop.  Where the loop traced three iterations of ``n``,
    the middle one's result stands for the ``n - 3`` not traced (detached
    copies: its backward already counts for theirs).  With autograd off
    those are held live while the stack is built, as the real loop's list
    holds them (with it on, :func:`steps` holds what each iteration keeps
    until its backward)."""
    tally = active()
    if len(ys) == n or tally is None or len(ys) != 3:
        return torch.stack(ys, dim)
    extra = 0 if torch.is_grad_enabled() else (n - 3) * nbytes(ys[1])
    tally.live += extra
    tally.peak = max(tally.peak, tally.live)
    try:
        return torch.stack(ys[:2] + [ys[1].detach()] * (n - 3) + ys[2:],
                           dim)
    finally:
        tally.live -= extra

