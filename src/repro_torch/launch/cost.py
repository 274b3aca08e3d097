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
    op that makes it until the last tensor on it is freed;
  * ``collective_bytes`` and ``collective_counts``: each collective a
    step on DTensors emits (``_c10d_functional``'s all-gather,
    all-reduce, reduce-scatter and all-to-all, and DTensor's
    ``shard_dim_alltoall``), by the reference's rule:
    bytes a device moves ~ 2 x the buffer for an all-reduce, 1 x for the
    others, the buffer of a reduce-style op the larger of its operand and
    its result (ring algorithms, (k - 1) / k ~ 1).

A tensor subclass (a DTensor, a collective's pending result) is passed
on to its own dispatch, so the tally counts the local ops it runs: on a
device mesh every number is a device's.  The ops DTensor runs on fake
tensors to propagate shapes are not counted.

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

import sys
import threading
import weakref
from typing import Iterator, Optional

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

_STATE = threading.local()


def _local(t):
    """A DTensor's local shard; any other tensor itself."""
    return getattr(t, "_local_tensor", t)


def _tensors(tree) -> list:
    return [_local(t) for t in tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor)]


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


#: ``_c10d_functional`` ops (and DTensor's own all-to-all) -> (the
#: reference's HLO name, multiplier, whether the buffer is the larger of
#: operand and result)
COLLECTIVES = {
    "shard_dim_alltoall": ("all-to-all", 1.0, True),
    "all_reduce": ("all-reduce", 2.0, True),
    "all_reduce_coalesced": ("all-reduce", 2.0, True),
    "all_gather_into_tensor": ("all-gather", 1.0, False),
    "all_gather_into_tensor_coalesced": ("all-gather", 1.0, False),
    "reduce_scatter_tensor": ("reduce-scatter", 1.0, True),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 1.0, True),
    "all_to_all_single": ("all-to-all", 1.0, True),
}


def collective(func, args, kwargs, out) -> tuple | None:
    """``(kind, bytes)`` of a collective op (the reference's rule, see
    the module docstring), or ``None`` for any other op."""
    if func.namespace not in ("_c10d_functional", "_dtensor"):
        return None
    rule = COLLECTIVES.get(func._schema.name.split("::")[-1])
    if rule is None:
        return None
    kind, mult, reduce_style = rule
    buf = sum(nbytes(t) for t in _tensors(out))
    if reduce_style:
        buf = max(buf, sum(nbytes(t) for t in _tensors((args, kwargs))))
    return kind, mult * buf


#: the tensor subclasses whose own dispatch runs local ops: a DTensor, a
#: collective's pending result
_WRAPPERS = ("DTensor", "AsyncCollectiveTensor")


def _subclassed(types) -> bool:
    """Whether an op's tensors include a :data:`_WRAPPERS` subclass."""
    return any(t.__name__ in _WRAPPERS for t in types)


def _propagating() -> bool:
    """Whether DTensor is running an op on fake tensors to propagate its
    shapes (a fake mode is active), which no device runs."""
    fake = sys.modules.get("torch._subclasses.fake_tensor")
    return fake is not None and torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


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
        self.collective_bytes = 0.0
        self.collective_counts: dict[str, int] = {}
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
            if self._storages.pop(key, None) is not None:
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
        if _subclassed(types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _is_view(func) or _propagating():
            return out
        k = self._repeats()
        results = _tensors(out)
        coll = collective(func, args, kwargs, out)
        if coll is not None:
            self.collective_bytes += k * coll[1]
            self.collective_counts[coll[0]] = \
                self.collective_counts.get(coll[0], 0) + k
        elif func.namespace == "_c10d_functional":
            # a wait or an autograd wrapper: no traffic, and on the device
            # its result is its operand; on meta a fresh tensor, so the
            # operand's bytes move to it
            for t in _tensors((args, kwargs)):
                if self._storages.pop(id(t.untyped_storage()), None):
                    self.live -= t.untyped_storage().nbytes()
            for t in results:
                self._track(t)
            return out
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


class Collectives(TorchDispatchMode):
    """The collectives emitted inside ``with Collectives() as c:``, by
    kind (``counts``) and bytes (``bytes``, the :class:`Tally`'s rule),
    and nothing else counted: what a step run on a card emits, to hold
    against a :class:`Tally`'s trace of it."""

    def __init__(self) -> None:
        super().__init__()
        self.bytes = 0.0
        self.counts: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _subclassed(types):
            return NotImplemented
        out = func(*args, **kwargs)
        coll = None if _propagating() else collective(func, args, kwargs,
                                                      out)
        if coll is not None:
            self.bytes += coll[1]
            self.counts[coll[0]] = self.counts.get(coll[0], 0) + 1
        return out


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
    cbytes, counts = tally.collective_bytes, dict(tally.collective_counts)
    live, first = tally.live, _next_sequence_nr() if later else 0
    yield 1
    tally.flops += (n - 3) * (tally.flops - flops)
    tally.bytes += (n - 3) * (tally.bytes - nbytes_)
    tally.collective_bytes += (n - 3) * (tally.collective_bytes - cbytes)
    for kind, c in list(tally.collective_counts.items()):
        tally.collective_counts[kind] = c + (n - 3) * (c - counts.get(kind,
                                                                      0))
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

