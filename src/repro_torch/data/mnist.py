"""MNIST for the paper's scenario, offline: local IDX files or a seeded
synthetic set.

The paper trains a small Keras model on MNIST per client.
:func:`load_mnist` reads the real IDX files from a local ``data_dir`` when
they are there and otherwise builds a **seeded synthetic digit set** with
the same geometry: each class is a fixed seeded template (blurred blob
constellation) plus pixel noise (:class:`SyntheticMnist`).  Linearly
separable enough that the paper's tiny MLP learns it in a few local
epochs, deterministic per (seed, client), and bit-identical to the
reference's synthetic set.  This port never downloads anything.

:func:`dirichlet_shards` produces the non-IID client partition (one
Dirichlet(alpha) class mixture per client) the federated scenarios train
over.
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import struct

import numpy as np


@dataclasses.dataclass
class SyntheticMnist:
    num_classes: int = 10
    side: int = 28
    seed: int = 0
    noise: float = 0.25

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        S = self.side
        self.templates = np.zeros((self.num_classes, S, S), np.float32)
        yy, xx = np.mgrid[0:S, 0:S]
        for c in range(self.num_classes):
            for _ in range(3):   # 3 gaussian blobs per class
                cy, cx = rng.uniform(4, S - 4, size=2)
                sig = rng.uniform(2.0, 4.0)
                self.templates[c] += np.exp(
                    -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig ** 2))
        self.templates /= self.templates.max(axis=(1, 2), keepdims=True)

    def sample(self, n: int, *, client: int = 0, step: int = 0
               ) -> tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(
            self.seed * 1_000_003 + client * 7919 + step)
        labels = rng.integers(0, self.num_classes, size=n)
        x = self.templates[labels] + rng.normal(
            0, self.noise, size=(n, self.side, self.side)).astype(np.float32)
        return x.reshape(n, -1).astype(np.float32), labels.astype(np.int32)


# --------------------------------------------------------------------------
# Real MNIST (IDX files) with the synthetic fallback
# --------------------------------------------------------------------------
_MNIST_FILES = {
    "x_train": "train-images-idx3-ubyte.gz",
    "y_train": "train-labels-idx1-ubyte.gz",
    "x_test": "t10k-images-idx3-ubyte.gz",
    "y_test": "t10k-labels-idx1-ubyte.gz",
}


def _read_idx(data: bytes) -> np.ndarray:
    """Parse one IDX payload (images: magic 2051; labels: magic 2049)."""
    if len(data) < 8:
        raise ValueError("truncated IDX payload")
    magic, n = struct.unpack(">II", data[:8])
    if magic == 2049:                              # labels: (n,) uint8
        return np.frombuffer(data, np.uint8, count=n, offset=8)
    if magic == 2051:                              # images: (n, rows, cols)
        rows, cols = struct.unpack(">II", data[8:16])
        arr = np.frombuffer(data, np.uint8, count=n * rows * cols, offset=16)
        return arr.reshape(n, rows * cols)
    raise ValueError(f"bad IDX magic {magic}")


def _local_idx(name: str, data_dir: str) -> np.ndarray:
    """One gzipped IDX file from ``data_dir``; raises if it is missing."""
    with gzip.open(os.path.join(data_dir, name), "rb") as f:
        return _read_idx(f.read())


@dataclasses.dataclass(frozen=True)
class MnistData:
    """A concrete train/test split, real or synthetic.

    ``x_*`` are float32 ``(n, 784)`` in [~0, ~1]; ``y_*`` are int32 labels.
    ``source`` records which path produced the data (``"real"`` |
    ``"synthetic"``) so benchmarks can report it honestly.
    """

    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    source: str

    @property
    def n_train(self) -> int:
        return int(self.x_train.shape[0])


def load_mnist(n_train: int = 8192, n_test: int = 1024, *, seed: int = 0,
               data_dir: str | None = None) -> MnistData:
    """Real MNIST from ``data_dir`` when all four IDX files are there, the
    seeded synthetic set otherwise (deterministic per ``seed`` and equal
    to the reference's ``load_mnist(download=False)``)."""
    if data_dir is not None and all(
            os.path.exists(os.path.join(data_dir, f))
            for f in _MNIST_FILES.values()):
        x_train = _local_idx(_MNIST_FILES["x_train"], data_dir)
        y_train = _local_idx(_MNIST_FILES["y_train"], data_dir)
        x_test = _local_idx(_MNIST_FILES["x_test"], data_dir)
        y_test = _local_idx(_MNIST_FILES["y_test"], data_dir)
        return MnistData(
            x_train=(x_train[:n_train].astype(np.float32) / 255.0),
            y_train=y_train[:n_train].astype(np.int32),
            x_test=(x_test[:n_test].astype(np.float32) / 255.0),
            y_test=y_test[:n_test].astype(np.int32),
            source="real")
    syn = SyntheticMnist(seed=seed)
    # Distinct (client, step) keys for the two splits so the test set is
    # never a subset of the training set.
    x_train, y_train = syn.sample(n_train, client=0, step=0)
    x_test, y_test = syn.sample(n_test, client=1_000_000, step=0)
    return MnistData(x_train=x_train, y_train=y_train,
                     x_test=x_test, y_test=y_test, source="synthetic")


def dirichlet_shards(labels: np.ndarray, n_clients: int, *,
                     alpha: float = 0.5, seed: int = 0,
                     shard_size: int | None = None) -> np.ndarray:
    """Non-IID client partition: one Dirichlet(alpha) class mixture each.

    Returns an int32 index matrix ``(n_clients, shard_size)`` into
    ``labels``'s axis 0 — a fixed-width layout so the vmapped trainer can
    gather every client's shard with one indexed load.  Small ``alpha``
    concentrates each client on few classes (the FedAvg-hostile regime);
    large ``alpha`` approaches IID.  Sampling is with replacement within a
    class, seeded, and consumes only ``default_rng(seed)`` draws in a fixed
    order — deterministic across platforms.
    """
    if n_clients < 1:
        raise ValueError("n_clients must be >= 1")
    if alpha <= 0:
        raise ValueError("dirichlet alpha must be > 0")
    labels = np.asarray(labels)
    n = labels.shape[0]
    if shard_size is None:
        shard_size = max(1, n // n_clients)
    classes = np.unique(labels)
    by_class = {int(c): np.flatnonzero(labels == c) for c in classes}
    rng = np.random.default_rng(seed)
    out = np.empty((n_clients, shard_size), np.int32)
    for i in range(n_clients):
        mix = rng.dirichlet(np.full(len(classes), alpha))
        drawn_classes = rng.choice(len(classes), size=shard_size, p=mix)
        for j, ci in enumerate(drawn_classes):
            pool = by_class[int(classes[ci])]
            out[i, j] = pool[int(rng.integers(len(pool)))]
    return out
