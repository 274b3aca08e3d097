"""Client compute: model families and train backends behind registries.

* :class:`ClientModel` — a registered model family (``register_model`` /
  ``make_model`` / ``available_models``) that trains one client as a
  per-client callable (:meth:`ClientModel.train_fn`, what
  :class:`~repro_torch.core.server.FLClient` runs) over a flat parameter
  vector on the device (:meth:`ClientModel.train_flat`).  Built-ins:
  ``"consensus"`` (the analytic quadratic objective the fleet benchmarks
  use) and ``"mlp"`` (the paper's MNIST MLP — ``repro_torch.models.mlp``
  over ``repro_torch.data.mnist`` non-IID dirichlet shards).
* :class:`TrainBackend` — how a batch of pending training steps executes
  (``register_train_backend`` / ``make_train_backend``): ``"python"``
  loops the per-client callables.

The reference's ``vmap``/``shard`` backends (and the ``BatchTrainer`` that
feeds them) arrive in a later slice of the port.
"""

from __future__ import annotations

import abc
from typing import Any, Callable

import numpy as np
import torch

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
    :meth:`train_flat` expresses the same ``w + lr * (c_k - w)`` step over
    a tensor.
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
    """One ``train_fn`` call per client, in batch order."""

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
