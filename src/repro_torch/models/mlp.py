"""The paper's MNIST MLP in PyTorch, as a :class:`ClientModel`.

A two-layer softmax classifier (784 -> hidden -> 10, tanh hidden layer)
trained with K local SGD steps per round on each client's non-IID
dirichlet shard (:func:`repro_torch.data.mnist.dirichlet_shards`).  Data,
shards and the training step live on the model's device; only the flat
parameter vector crosses to and from the host, because parameters travel
over the simulated wire as bytes.

:meth:`MnistMLPModel.train_batch` trains K clients at once (the ``vmap``
and ``shard`` train backends): every row's minibatch indices are drawn on
the host first, by the same :func:`minibatch_indices` as the per-client
path, and cross to the device in one copy; each local step is then one
``torch.func.vmap`` of a pure step (:func:`sgd_step`:
``torch.func.grad_and_value`` of :func:`cross_entropy`, and the SGD
update as a tensor expression) over the K rows, with the loop over the
local steps outside the map.

The reference draws each step's minibatch with JAX's threefry generator,
which torch cannot reproduce.  Every draw here goes through the one
module-level function :func:`minibatch_indices`, keyed only by
``(seed, client, round, step)`` (never by call order); tests replace it
with the reference's draws to compare the two trainers step for step.

Float32 matrix products on the card run in full float32 (PyTorch's
default, ``torch.backends.cuda.matmul.allow_tf32 = False``); this model
uses no convolution.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import convert
from repro_torch import device as _device
from repro_torch.core.client_compute import ClientModel
from repro_torch.core.packetizer import flatten_to_vector, unflatten_from_vector
from repro_torch.data.mnist import dirichlet_shards, load_mnist

_MASK63 = (1 << 63) - 1


def _mix(x: int) -> int:
    """splitmix64 finalizer on a python int (64-bit wrap-around)."""
    x &= (1 << 64) - 1
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return x ^ (x >> 31)


def minibatch_indices(seed: int, client: int, round_idx: int, step: int,
                      n: int, shard_len: int,
                      device: torch.device) -> torch.Tensor:
    """``n`` int64 positions in ``[0, shard_len)`` for one local SGD step,
    drawn from a ``torch.Generator`` seeded by a splitmix64 hash of
    ``(seed, client, round_idx, step)``."""
    key = 0x9E3779B97F4A7C15
    for part in (seed, client, round_idx, step):
        key = _mix(key ^ (int(part) & ((1 << 64) - 1)))
    gen = torch.Generator(device="cpu")
    gen.manual_seed(key & _MASK63)
    return torch.randint(0, shard_len, (n,), generator=gen).to(device)


def forward(params: dict[str, torch.Tensor], x: torch.Tensor
            ) -> torch.Tensor:
    """Logits of ``x`` (B, 784): ``tanh(x @ w1 + b1) @ w2 + b2``."""
    h = torch.tanh(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def cross_entropy(params: dict[str, torch.Tensor], x: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
    """Mean log-softmax cross-entropy of the batch."""
    return F.cross_entropy(forward(params, x), y)


def sgd_step(params: dict[str, torch.Tensor], x: torch.Tensor,
             y: torch.Tensor, lr: float
             ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """One SGD step of one client, pure (``torch.func.vmap`` maps it over
    clients): the new parameters ``w - lr * grad`` and the step's loss."""
    grads, loss = torch.func.grad_and_value(cross_entropy)(params, x, y)
    return {k: w - lr * grads[k] for k, w in params.items()}, loss


class MnistMLPModel(ClientModel):
    """784 -> hidden -> 10 MLP over per-client dirichlet shards.

    Trains on the seeded synthetic MNIST unless ``data_dir`` holds the real
    IDX files.  ``device`` (default: the package default) holds the data
    and runs every training and evaluation step.
    """

    name = "mlp"

    def __init__(self, n_clients: int, *, seed: int = 0, hidden: int = 32,
                 local_steps: int = 4, batch_size: int = 32,
                 lr: float = 0.1, alpha: float = 0.5,
                 n_train: int = 8192, n_test: int = 1024,
                 shard_size: int = 256, data_dir: str | None = None,
                 device: _device.DeviceLike | None = None):
        super().__init__(n_clients, seed=seed)
        self.hidden = int(hidden)
        self.local_steps = int(local_steps)
        self.batch_size = int(batch_size)
        self.lr = float(lr)
        self.device = _device.resolve(device)
        self.data = load_mnist(n_train, n_test, seed=seed, data_dir=data_dir)
        self.shards = dirichlet_shards(
            self.data.y_train, n_clients, alpha=alpha, seed=seed,
            shard_size=shard_size)
        dev = self.device
        self._x = torch.from_numpy(self.data.x_train).to(dev)
        self._y = torch.from_numpy(self.data.y_train).long().to(dev)
        self._x_test = torch.from_numpy(self.data.x_test).to(dev)
        self._y_test = torch.from_numpy(self.data.y_test).long().to(dev)
        self._shards = torch.from_numpy(self.shards).long().to(dev)
        self.layout = convert.layout_of(self.init_params())
        self.n_params = sum(int(np.prod(s)) for _, s in self.layout)

    # -- ClientModel ------------------------------------------------------
    def init_params(self) -> Any:
        rng = np.random.default_rng(self.seed)
        h = self.hidden
        scale1 = np.sqrt(2.0 / 784.0)
        scale2 = np.sqrt(2.0 / h)
        return {
            "w1": (rng.standard_normal((784, h)) * scale1).astype(np.float32),
            "b1": np.zeros(h, np.float32),
            "w2": (rng.standard_normal((h, 10)) * scale2).astype(np.float32),
            "b2": np.zeros(10, np.float32),
        }

    @torch.no_grad()
    def _test_logits(self, params: Any) -> torch.Tensor:
        p, _ = convert.from_reference(params, self.device)
        return forward(p, self._x_test)

    def loss(self, params: Any) -> float:
        """Mean softmax cross-entropy on the held-out test split."""
        return float(F.cross_entropy(self._test_logits(params),
                                     self._y_test))

    def accuracy(self, params: Any) -> float:
        pred = self._test_logits(params).argmax(dim=1)
        return float((pred == self._y_test).float().mean())

    def eval_metrics(self, params: Any) -> dict:
        return {"loss": self.loss(params), "accuracy": self.accuracy(params),
                "data_source": self.data.source}

    def train_fn(self, i: int, profile: Any = None) -> Callable:
        template = self.init_params()
        idx = int(i)

        def _train(params: Any, round_idx: int, client: Any
                   ) -> tuple[Any, dict]:
            vec = torch.from_numpy(flatten_to_vector(params)).to(self.device)
            new, aux = self.train_flat(vec, idx, int(round_idx))
            tree = unflatten_from_vector(new.cpu().numpy(), template)
            return tree, {k: float(v) for k, v in aux.items()}

        return _train

    def train_flat(self, vec: torch.Tensor, client_idx: int,
                   round_idx: int) -> tuple[torch.Tensor, dict]:
        """``local_steps`` SGD steps of one client from the flat float32
        parameters ``vec`` (on the model's device); returns the new flat
        vector and ``{"train_loss": loss of the last step}``."""
        params = convert.unflatten(vec.to(self.device, torch.float32),
                                   self.layout)
        shard = self._shards[client_idx]
        loss = torch.zeros((), device=self.device)
        for step in range(self.local_steps):
            pick = minibatch_indices(self.seed, client_idx, round_idx, step,
                                     self.batch_size, shard.shape[0],
                                     self.device)
            rows = shard[pick]
            p = {k: v.detach().requires_grad_(True)
                 for k, v in params.items()}
            loss = cross_entropy(p, self._x[rows], self._y[rows])
            grads = torch.autograd.grad(loss, list(p.values()))
            with torch.no_grad():
                params = {k: w - self.lr * g
                          for (k, w), g in zip(p.items(), grads)}
        return (convert.flatten(params, self.layout),
                {"train_loss": loss.detach()})

    def train_batch(self, stack: np.ndarray, client_idx: np.ndarray,
                    round_idx: np.ndarray
                    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """:meth:`train_flat` for K clients at once: ``stack`` (K, n_params)
        float32 rows trained ``local_steps`` SGD steps each, every step one
        ``torch.func.vmap`` of :func:`sgd_step` over the rows.  Returns the
        (K, n_params) result on the model's device and ``{"train_loss":
        (K,) losses of the last step}``."""
        dev = self.device
        k = stack.shape[0]
        shard_len = self._shards.shape[1]
        picks = torch.stack([
            torch.stack([minibatch_indices(self.seed, int(c), int(r), step,
                                           self.batch_size, shard_len,
                                           torch.device("cpu"))
                         for step in range(self.local_steps)])
            for c, r in zip(client_idx, round_idx)])
        vec = torch.from_numpy(np.ascontiguousarray(stack, np.float32))
        vec, picks = vec.to(dev), picks.to(dev)
        shards = self._shards[torch.from_numpy(
            np.asarray(client_idx, np.int64)).to(dev)]
        params, off = {}, 0
        for name, shape in self.layout:
            size = int(np.prod(shape))
            params[name] = vec[:, off:off + size].reshape(k, *shape)
            off += size
        step = torch.func.vmap(sgd_step, in_dims=(0, 0, 0, None))
        loss = torch.zeros(k, device=dev)
        for s in range(self.local_steps):
            rows = torch.gather(shards, 1, picks[:, s])
            params, loss = step(params, self._x[rows], self._y[rows],
                                self.lr)
        return (torch.cat([params[name].reshape(k, -1)
                           for name, _ in self.layout], dim=1),
                {"train_loss": loss})
