"""Functional optimizers over parameter trees, the reference's
``repro.optim.optimizers`` in PyTorch.

``init(params) -> state`` and ``update(grads, state, params, step) ->
(new_params, new_state, metrics)`` are pure functions of trees of tensors
(no ``torch.optim``): the update math is the reference's, in its order,
in float32 whatever the parameter dtype.  AdamW keeps float32 moments for
bfloat16 parameters (``moments_dtype``), the standard mixed-precision
recipe.  ``state_specs(param_specs)`` gives the state's logical-axis
tree (the reference's), for :mod:`repro_torch.distributed.sharding`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.distributed import sharding as sh

from repro_torch.tree import rebuild, tree_leaves, tree_map


class TrainState(NamedTuple):
    step: torch.Tensor          # 0-d int32
    params: Any
    opt_state: Any


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in leaves))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm


def _clipped(grads, grad_clip: float):
    if grad_clip > 0:
        return clip_by_global_norm(grads, grad_clip)
    return grads, global_norm(grads)


def _t(step, device) -> torch.Tensor:
    """``step + 1`` as a float32 tensor (the bias-correction exponent)."""
    s = step if isinstance(step, torch.Tensor) else torch.tensor(step)
    return (s.to(device) + 1).to(torch.float32)


class Optimizer:
    def init(self, params):  # pragma: no cover - interface
        raise NotImplementedError

    def update(self, grads, state, params, step):  # pragma: no cover
        raise NotImplementedError

    def state_specs(self, param_specs):
        """Logical-axis specs for the optimizer state, mirroring params."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class AdamW(Optimizer):
    schedule: Callable[[Any], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # Low-precision moments for very large models (the update math stays
    # in float32).
    moments_dtype: str = "float32"

    def init(self, params):
        dt = getattr(torch, self.moments_dtype)

        def zeros(p):
            return torch.zeros(p.shape, dtype=dt, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def update(self, grads, state, params, step):
        grads, gnorm = _clipped(grads, self.grad_clip)
        lr = self.schedule(step).to(gnorm.device)
        t = _t(step, gnorm.device)
        bc1 = 1.0 - self.b1 ** t
        bc2 = 1.0 - self.b2 ** t
        mdt = getattr(torch, self.moments_dtype)

        def upd(g, m, v, p):
            g32 = g.float()
            m2 = self.b1 * m.float() + (1 - self.b1) * g32
            v2 = self.b2 * v.float() + (1 - self.b2) * g32 * g32
            mhat = m2 / bc1
            vhat = v2 / bc2
            delta = mhat / (torch.sqrt(vhat) + self.eps)
            if self.weight_decay:
                delta = delta + self.weight_decay * p.float()
            return ((p.float() - lr * delta).to(p.dtype), m2.to(mdt),
                    v2.to(mdt))

        out = [upd(*a) for a in zip(tree_leaves(grads),
                                    tree_leaves(state["m"]),
                                    tree_leaves(state["v"]),
                                    tree_leaves(params))]
        new_params = rebuild(params, iter(o[0] for o in out))
        new_m = rebuild(params, iter(o[1] for o in out))
        new_v = rebuild(params, iter(o[2] for o in out))
        return new_params, {"m": new_m, "v": new_v}, {
            "grad_norm": gnorm, "lr": lr}

    def state_specs(self, param_specs):
        return {"m": param_specs, "v": param_specs}


def _leaf_states(params, f_tree) -> list:
    """The per-parameter state dicts of ``f_tree`` (a tree shaped like
    ``params`` whose leaves are dicts), in ``params``' leaf order."""
    if isinstance(params, dict):
        return [s for key in sorted(params)
                for s in _leaf_states(params[key], f_tree[key])]
    if isinstance(params, (list, tuple)):
        return [s for sub, st in zip(params, f_tree)
                for s in _leaf_states(sub, st)]
    if params is None:
        return []
    return [f_tree]


def _mean(x, dim, pdim, keepdim=False):
    return torch.mean(x) if dim is None else x.mean(dim=dim, keepdim=keepdim)


def _on_shards(upd, g, st, p):
    """A factored update of a laid-out parameter run on its shards (so no
    broadcast of a row factor against a column factor is laid out
    whole): the means over split axes are a local sum all-reduced over
    the mesh axes that split the parameter's axis, over its length."""
    from torch.distributed.tensor import DTensor
    mesh_dims = {}
    for d, pl in enumerate(p.placements):
        if pl.is_shard():
            mesh_dims.setdefault(pl.dim, []).append(d)

    def mean(x, dim, pdim, keepdim=False):
        if dim is None:
            out, dims, n = x.sum(), sum(mesh_dims.values(), []), p.numel()
        else:
            out, dims = x.sum(dim=dim, keepdim=keepdim), mesh_dims.get(pdim,
                                                                      [])
            n = p.shape[pdim]
        for d in dims:
            out = sh.all_reduce_mesh_dim(out, "sum", d)
        return out / n

    loc = {k: v.to_local() for k, v in st.items()}
    new_p, new_st = upd(g.to_local(), loc, p.to_local(), mean)
    wrap = functools.partial(DTensor.from_local, device_mesh=p.device_mesh,
                             run_check=False)
    return (wrap(new_p, placements=p.placements),
            {k: wrap(v, placements=st[k].placements, shape=st[k].shape,
                     stride=st[k].stride()) for k, v in new_st.items()})


@dataclasses.dataclass(frozen=True)
class Adafactor(Optimizer):
    """Factored second-moment optimizer (Shazeer & Stern 2018): v is kept
    as per-row/per-column running means, the first moment omitted."""

    schedule: Callable[[Any], torch.Tensor]
    decay: float = 0.8          # \\hat{beta2}_t = 1 - t^-decay
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    grad_clip: float = 1.0

    def init(self, params):
        def leaf(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        return {"f": rebuild(params, iter([leaf(p) for p in
                                           tree_leaves(params)]))}

    def update(self, grads, state, params, step):
        grads, gnorm = _clipped(grads, self.grad_clip)
        lr = self.schedule(step).to(gnorm.device)
        t = _t(step, gnorm.device)
        beta2 = 1.0 - t ** (-self.decay)

        def upd(g, st, p, mean=_mean):
            """One leaf's update; ``mean(x, dim, pdim, keepdim)`` is the
            mean of ``x`` over its axis ``dim`` (``None``: every axis),
            the parameter's axis ``pdim``."""
            g32 = g.float()
            g2 = g32 * g32 + self.eps
            n = p.dim()
            if n >= 2:
                vr = beta2 * st["vr"] + (1 - beta2) * mean(g2, -1, n - 1)
                vc = beta2 * st["vc"] + (1 - beta2) * mean(g2, -2, n - 2)
                denom = (vr[..., None] / torch.clamp(
                    mean(vr, -1, n - 2, True), min=self.eps)[..., None]) \
                    * vc[..., None, :]
                u = g32 * torch.rsqrt(denom + self.eps)
                new_st = {"vr": vr, "vc": vc}
            else:
                v = beta2 * st["v"] + (1 - beta2) * g2
                u = g32 * torch.rsqrt(v + self.eps)
                new_st = {"v": v}
            # update clipping by RMS (Adafactor's stabilizer)
            rms_u = torch.sqrt(mean(u * u, None, None) + 1e-30)
            u = u / torch.clamp(rms_u / self.clip_threshold, min=1.0)
            if self.weight_decay:
                u = u + self.weight_decay * p.float()
            return (p.float() - lr * u).to(p.dtype), new_st

        def leaf(g, st, p):
            if not sh.is_distributed(p):
                return upd(g, st, p)
            return _on_shards(upd, g, st, p)

        out = [leaf(g, st, p) for g, st, p in zip(
            tree_leaves(grads), _leaf_states(params, state["f"]),
            tree_leaves(params))]
        new_params = rebuild(params, iter(o[0] for o in out))
        new_f = rebuild(params, iter(o[1] for o in out))
        return new_params, {"f": new_f}, {"grad_norm": gnorm, "lr": lr}

    def state_specs(self, param_specs):
        """Factored leaves (rank >= 2) keep the row spec (the last axis
        dropped) and the column spec (the second to last dropped)."""
        from repro_torch.distributed.sharding import map_specs

        def leaf(spec):
            if len(spec) >= 2:
                return {"vr": spec[:-1], "vc": spec[:-2] + spec[-1:]}
            return {"v": spec}
        return {"f": map_specs(leaf, param_specs)}


@dataclasses.dataclass(frozen=True)
class Sgd(Optimizer):
    schedule: Callable[[Any], torch.Tensor]
    momentum: float = 0.0
    grad_clip: float = 0.0

    def init(self, params):
        if self.momentum == 0.0:
            return {}
        return {"mom": tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)}

    def update(self, grads, state, params, step):
        grads, gnorm = _clipped(grads, self.grad_clip)
        lr = self.schedule(step).to(gnorm.device)
        if self.momentum == 0.0:
            new_params = tree_map(
                lambda p, g: (p.float() - lr * g.float()).to(p.dtype),
                params, grads)
            return new_params, {}, {"grad_norm": gnorm, "lr": lr}
        new_mom = tree_map(lambda m, g: self.momentum * m + g.float(),
                           state["mom"], grads)
        new_params = tree_map(
            lambda p, m: (p.float() - lr * m).to(p.dtype), params, new_mom)
        return new_params, {"mom": new_mom}, {"grad_norm": gnorm, "lr": lr}

    def state_specs(self, param_specs):
        return {} if self.momentum == 0.0 else {"mom": param_specs}


def make_optimizer(name: str, schedule, **kw) -> Optimizer:
    if name == "adamw":
        return AdamW(schedule=schedule, **kw)
    if name == "adafactor":
        kw.pop("moments_dtype", None)
        return Adafactor(schedule=schedule, **kw)
    if name == "sgd":
        return Sgd(schedule=schedule, **kw)
    raise ValueError(f"unknown optimizer {name}")
