"""Client compute: batched local training behind registries.

* :class:`ClientModel` — a registered model family (``register_model`` /
  ``make_model`` / ``available_models``) that trains one client as a
  per-client callable (:meth:`ClientModel.train_fn`, what
  :class:`~repro_torch.core.server.FLClient` runs) over a flat parameter
  vector on the device (:meth:`ClientModel.train_flat`), **and** K clients
  at once (:meth:`ClientModel.train_batch`: one ``torch.func.vmap`` of the
  model's pure step over the stacked rows).  Built-ins: ``"consensus"``
  (the analytic quadratic objective the fleet benchmarks use) and
  ``"mlp"`` (the paper's MNIST MLP — ``repro_torch.models.mlp`` over
  ``repro_torch.data.mnist`` non-IID dirichlet shards).
* :class:`TrainBackend` — how a batch of pending training steps executes
  (``register_train_backend`` / ``make_train_backend``): ``"python"``
  loops the per-client callables, ``"vmap"`` trains the whole batch in
  one :meth:`~ClientModel.train_batch` call on the device, ``"shard"`` is
  the vmap backend on the one card this port drives.
* :class:`BatchTrainer` — the orchestrator glue.  ``ServerCore`` (and the
  hierarchical :class:`~repro_torch.core.topology.CellScheduler` cells
  through their nested cores, and
  :class:`~repro_torch.core.topology.GossipSystem`) *submit* a session's
  training input the moment its model is delivered and *collect* the
  result when the session's training timer fires.  Because local training
  is deterministic and per-client independent, the trainer may compute
  any pending set in one batched call without changing a single event:
  the first timer to fire flushes everything submitted so far — in a
  typical round that is the whole roster, so K clients train as one
  vmapped batch while the simulator still observes per-client completion
  times.

With no trainer attached, ``ServerCore.schedule_training`` runs the
per-client code, pinned by the orchestrator digests.
"""

from __future__ import annotations

import abc
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.packetizer import flatten_to_vector, unflatten_from_vector


# --------------------------------------------------------------------------
# The model contract + registry
# --------------------------------------------------------------------------
class ClientModel(abc.ABC):
    """A model family the fleet can train.

    * :meth:`train_fn` — ``(params_tree, round_idx, client) -> (tree,
      metrics)``, the per-client callable handed to
      :class:`~repro_torch.core.server.FLClient`.
    * :meth:`train_flat` — ``(flat_vec, client_idx, round_idx) ->
      (flat_vec', aux)`` on tensors: one client's local round on the
      device (``aux`` is a dict of scalar training metrics).
    * :meth:`train_batch` — ``(stack, client_idx, round_idx) -> (stack',
      aux)``: K clients' local rounds from a ``(K, n_params)`` float32
      stack and int vectors of client indices and rounds, as one
      ``torch.func.vmap`` of a pure step on the device (``aux`` maps each
      metric to a ``(K,)`` tensor).  The same arithmetic as
      :meth:`train_flat` row by row; ``tests/test_torch_client_compute.py``
      holds the two within a few float32 ULP.
    """

    name: str = "abstract"

    def __init__(self, n_clients: int, *, seed: int = 0):
        self.n_clients = int(n_clients)
        self.seed = int(seed)

    @abc.abstractmethod
    def init_params(self) -> Any:
        """The global model template (numpy pytree, float32 leaves)."""

    @abc.abstractmethod
    def loss(self, params: Any) -> float:
        """Global objective value (lower is better)."""

    def eval_metrics(self, params: Any) -> dict:
        """Benchmark-facing evaluation record (subclasses extend)."""
        return {"loss": self.loss(params)}

    @abc.abstractmethod
    def train_fn(self, i: int, profile: Any = None) -> Callable:
        """The i-th client's per-client training callable."""

    @abc.abstractmethod
    def train_flat(self, vec, client_idx: int, round_idx: int):
        """One client's local training over a flat parameter tensor."""

    @abc.abstractmethod
    def train_batch(self, stack: np.ndarray, client_idx: np.ndarray,
                    round_idx: np.ndarray
                    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """K clients' local training as one vmapped call on the device."""


_MODELS: dict[str, Callable[..., ClientModel]] = {}


def register_model(name: str, factory: Callable[..., ClientModel], *,
                   overwrite: bool = False) -> None:
    """Register a model factory (the transport registry idiom: silent
    shadowing of a built-in would invalidate benchmarks)."""
    if not overwrite and name in _MODELS:
        raise ValueError(f"model {name!r} is already registered "
                         f"(pass overwrite=True to replace it)")
    _MODELS[name] = factory


def make_model(name: str, n_clients: int, *, seed: int = 0,
               **kwargs) -> ClientModel:
    try:
        factory = _MODELS[name]
    except KeyError:
        raise ValueError(f"unknown model {name!r}; registered models: "
                         f"{available_models()}") from None
    return factory(n_clients, seed=seed, **kwargs)


def available_models() -> list[str]:
    return sorted(_MODELS)


# --------------------------------------------------------------------------
# Built-in model: the analytic consensus objective
# --------------------------------------------------------------------------
class ConsensusModel(ClientModel):
    """:class:`~repro_torch.core.fleet.ConsensusObjective` as a registered
    model.

    The python path delegates to the objective's own ``train_fn`` — the
    numpy fleet workload, bit-identical to the reference's — while
    :meth:`train_flat` and :meth:`train_batch` express the same
    ``w + lr * (c_k - w)`` step over tensors, on the package's current
    device.
    """

    name = "consensus"

    def __init__(self, n_clients: int, *, seed: int = 0,
                 n_params: int = 1024, lr: float = 0.5,
                 heterogeneity: float = 0.1):
        from repro_torch.core.fleet import ConsensusObjective
        super().__init__(n_clients, seed=seed)
        self.objective = ConsensusObjective(
            n_clients, n_params, seed=seed, lr=lr, heterogeneity=heterogeneity)

    def init_params(self) -> Any:
        return self.objective.init_params()

    def loss(self, params: Any) -> float:
        return self.objective.loss(params)

    def train_fn(self, i: int, profile: Any = None) -> Callable:
        return self.objective.train_fn(i, profile)

    def train_flat(self, vec, client_idx, round_idx):
        target = torch.from_numpy(
            self.objective.targets[client_idx]).to(vec.device)
        w = vec.to(torch.float32)
        new = w + self.objective.lr * (target - w)
        return new, {"local_gap": torch.mean((w - target) ** 2)}

    def train_batch(self, stack, client_idx, round_idx):
        dev = _device.resolve()
        w = torch.from_numpy(np.ascontiguousarray(stack, np.float32)).to(dev)
        targets = torch.from_numpy(
            self.objective.targets[np.asarray(client_idx)]).to(dev)
        lr = self.objective.lr

        def step(w, target):
            return (w + lr * (target - w),
                    {"local_gap": torch.mean((w - target) ** 2)})
        return torch.func.vmap(step)(w, targets)


register_model("consensus", ConsensusModel)


def _mlp_factory(n_clients: int, *, seed: int = 0, **kwargs) -> ClientModel:
    # Lazy: the model module builds on this one.
    from repro_torch.models.mlp import MnistMLPModel
    return MnistMLPModel(n_clients, seed=seed, **kwargs)


register_model("mlp", _mlp_factory)


# --------------------------------------------------------------------------
# Train backends
# --------------------------------------------------------------------------
class TrainBackend(abc.ABC):
    """Executes a batch of independent local-training steps.

    ``train(model, stack, client_idx, round_idx)`` takes the K pending
    steps as a stacked float32 matrix ``(K, n_params)`` plus int32 vectors
    of client indices and round numbers, and returns ``(new_stack,
    metrics)`` where ``metrics`` is one dict per row.
    """

    name: str = "abstract"

    @abc.abstractmethod
    def train(self, model: ClientModel, stack: np.ndarray,
              client_idx: np.ndarray, round_idx: np.ndarray
              ) -> tuple[np.ndarray, list[dict]]:
        ...


class PythonLoopBackend(TrainBackend):
    """One ``train_fn`` call per client, in batch order: the very callables
    the per-session path runs, so it is bit-identical to it."""

    name = "python"

    def __init__(self) -> None:
        self._fns: dict[tuple[int, int], Callable] = {}
        self._template: dict[int, Any] = {}

    def _fn(self, model: ClientModel, i: int) -> Callable:
        key = (id(model), i)
        fn = self._fns.get(key)
        if fn is None:
            fn = self._fns[key] = model.train_fn(i)
        return fn

    def train(self, model, stack, client_idx, round_idx):
        template = self._template.get(id(model))
        if template is None:
            template = self._template[id(model)] = model.init_params()
        out = np.empty_like(stack)
        metrics: list[dict] = []
        for j in range(stack.shape[0]):
            tree = unflatten_from_vector(stack[j], template)
            new_tree, m = self._fn(model, int(client_idx[j]))(
                tree, int(round_idx[j]), None)
            out[j] = flatten_to_vector(new_tree)
            metrics.append(m)
        return out, metrics


def _aux_to_rows(aux: dict, k: int) -> list[dict]:
    """Split a dict of (K,)-tensors into K per-row metric dicts."""
    cols = {key: np.asarray(torch.as_tensor(val).detach().cpu(), np.float32)
            for key, val in aux.items()}
    return [{key: float(col[j]) for key, col in cols.items()}
            for j in range(k)]


class VmapBackend(TrainBackend):
    """One :meth:`ClientModel.train_batch` call per flush: the stack crosses
    to the device in one copy, every row trains in one
    ``torch.func.vmap`` of the model's pure step, and the result crosses
    back in one copy.  Nothing is compiled, so a batch runs at its own
    size: K rows in, K rows out, with no padding.  On ``cuda`` without a
    card it raises (the model's device does)."""

    name = "vmap"

    def train(self, model, stack, client_idx, round_idx):
        k = stack.shape[0]
        new, aux = model.train_batch(
            np.ascontiguousarray(stack, np.float32),
            np.asarray(client_idx, np.int64), np.asarray(round_idx, np.int64))
        return (new.detach().to("cpu", torch.float32).numpy(),
                _aux_to_rows(aux, k))


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


class ShardBackend(VmapBackend):
    """The reference's ``shard_map`` over the client mesh
    (:func:`repro_torch.distributed.fl_mesh.client_mesh`).  On one device
    it *is* the vmap backend, as the reference's is.  Over the d ranks of
    a group (:mod:`repro_torch.distributed.ranks`, one process a rank)
    the batch is padded by the reference's rule, to ``max(d,
    next_pow2(K))`` rounded up to a multiple of d by repeating the last
    row, client index and round index; rank r trains its contiguous slab
    of the padded rows through the vmap path, and the updated rows and
    their metrics are all-gathered, so every rank returns the same first
    K.  A single process that sees several cards and joined no group
    raises instead of running on one."""

    name = "shard"

    def train(self, model, stack, client_idx, round_idx):
        from repro_torch.distributed import ranks
        from repro_torch.distributed.fl_mesh import client_mesh
        d = client_mesh().size
        if d <= 1:
            return super().train(model, stack, client_idx, round_idx)
        if not ranks.active():
            raise NotImplementedError(
                f"train backend 'shard' over {d} cards in one process: "
                f"spreading a batch over several cards takes one rank a "
                f"card (torchrun --nproc-per-node {d} -m "
                f"repro_torch.fleet_sim --train-backend shard "
                f"--dist-backend nccl); use 'vmap', or make one card "
                f"visible")
        k = stack.shape[0]
        kp = -(-max(d, _next_pow2(k)) // d) * d
        if kp != k:
            pad = kp - k
            stack = np.concatenate([stack, np.repeat(stack[-1:], pad, 0)])
            client_idx = np.concatenate(
                [client_idx, np.repeat(client_idx[-1:], pad)])
            round_idx = np.concatenate(
                [round_idx, np.repeat(round_idx[-1:], pad)])
        per = kp // d
        slab = slice(ranks.rank() * per, (ranks.rank() + 1) * per)
        new, aux = model.train_batch(
            np.ascontiguousarray(stack[slab], np.float32),
            np.asarray(client_idx[slab], np.int64),
            np.asarray(round_idx[slab], np.int64))
        keys = sorted(aux)
        rows = torch.cat([new.to(torch.float32)] + [
            torch.as_tensor(aux[key]).to(new.device, torch.float32)
            .reshape(per, 1) for key in keys], dim=1)
        rows = ranks.all_gather(rows).to("cpu").numpy()[:k]
        n = stack.shape[1]
        return (np.ascontiguousarray(rows[:, :n]),
                _aux_to_rows({key: rows[:, n + j]
                              for j, key in enumerate(keys)}, k))


_TRAIN_BACKENDS: dict[str, Callable[[], TrainBackend]] = {}


def register_train_backend(name: str, factory: Callable[[], TrainBackend],
                           *, overwrite: bool = False) -> None:
    if not overwrite and name in _TRAIN_BACKENDS:
        raise ValueError(f"train backend {name!r} is already registered "
                         f"(pass overwrite=True to replace it)")
    _TRAIN_BACKENDS[name] = factory


def make_train_backend(name: str) -> TrainBackend:
    try:
        factory = _TRAIN_BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown train backend {name!r}; registered backends: "
            f"{available_train_backends()}") from None
    return factory()


def available_train_backends() -> list[str]:
    return sorted(_TRAIN_BACKENDS)


register_train_backend("python", PythonLoopBackend)
register_train_backend("vmap", VmapBackend)
register_train_backend("shard", ShardBackend)


# --------------------------------------------------------------------------
# The orchestrator glue: submit at delivery, collect at the timer
# --------------------------------------------------------------------------
class BatchTrainer:
    """Opportunistic batching without touching the event calendar.

    A session's training *input* is fully known the moment its downlink
    delivers (``ServerCore.schedule_training`` runs then); only the
    *result* is deferred by ``train_time_ns``.  So the core submits the
    input immediately and collects at the timer — and because every local
    step is deterministic and independent, ``collect`` may flush all
    currently-pending submissions as one backend call without perturbing
    any event time or order.  In a sync round the whole roster's downlinks
    usually land before the fastest client finishes training, so the first
    ``collect`` trains the entire round in one vmapped batch; stragglers
    whose models arrive later simply join the next flush.
    """

    def __init__(self, model: ClientModel, backend: TrainBackend,
                 client_index: dict[str, int]):
        self.model = model
        self.backend = backend
        self.client_index = dict(client_index)
        self._template = model.init_params()
        self._pending: list[tuple[Any, Any, int, int]] = []
        self._results: dict[Any, tuple[Any, Any, dict]] = {}
        #: Flush sizes, newest last — benchmarks read this to report how
        #: much batching the event schedule actually allowed.
        self.batch_sizes: list[int] = []

    def submit(self, key: Any, addr: str, params_tree: Any,
               round_idx: int) -> None:
        """Register one session's training input (model just delivered)."""
        if key in self._results:
            raise RuntimeError(f"duplicate submit for session key {key!r}")
        try:
            idx = self.client_index[addr]
        except KeyError:
            raise KeyError(f"no model client index for {addr!r}") from None
        self._pending.append((key, params_tree, idx, int(round_idx)))

    def flush(self) -> None:
        """Train every pending submission as one backend call."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        stack = np.stack([flatten_to_vector(tree) for _, tree, _, _ in
                          pending]).astype(np.float32, copy=False)
        client_idx = np.asarray([i for _, _, i, _ in pending], np.int32)
        round_idx = np.asarray([r for _, _, _, r in pending], np.int32)
        new_stack, metrics = self.backend.train(
            self.model, stack, client_idx, round_idx)
        self.batch_sizes.append(len(pending))
        for j, (key, tree, _, _) in enumerate(pending):
            new_tree = unflatten_from_vector(
                np.asarray(new_stack[j], np.float32), self._template)
            self._results[key] = (tree, new_tree, metrics[j])

    def collect(self, key: Any) -> tuple[Any, Any, dict]:
        """(received_tree, trained_tree, metrics) for a submitted key."""
        if key not in self._results:
            self.flush()
        try:
            return self._results.pop(key)
        except KeyError:
            raise KeyError(f"session key {key!r} was never submitted") from \
                None


def attach_trainer(system: Any, trainer: BatchTrainer) -> int:
    """Wire ``trainer`` into every training site of a built system.

    Returns the number of cores/systems wired: a star's single
    ``ServerCore``, every hierarchical edge cell's nested core (the root
    never trains — its "training" is the cell round), or the gossip
    system itself.
    """
    from repro_torch.core.rounds import FederatedSystem
    from repro_torch.core.topology import GossipSystem, HierSystem
    if isinstance(system, FederatedSystem):
        system.core.batch_trainer = trainer
        return 1
    if isinstance(system, HierSystem):
        for edge in system.edges:
            edge.core.batch_trainer = trainer
        return len(system.edges)
    if isinstance(system, GossipSystem):
        system.batch_trainer = trainer
        return 1
    raise TypeError(f"don't know how to attach a trainer to "
                    f"{type(system).__name__}")
