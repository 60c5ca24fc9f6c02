"""Keras-style dataset loaders (reference: python/flexflow/keras/datasets —
mnist/cifar10/reuters wrappers).

Nothing is downloaded: each loader reads a local `<name>.npz` under
KERAS_DATA_DIR (default ~/.keras/datasets) when there is one, else makes
a deterministic synthetic dataset of the right shapes and dtypes, as the
JAX package's loaders do (linearly separable, so models train).
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def _synthetic_classification(n, shape, classes, seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, *shape).astype(np.float32)
    w = rng.randn(int(np.prod(shape)), classes).astype(np.float32)
    y = np.argmax(x.reshape(n, -1) @ w, axis=1).astype(np.int64)
    return x, y


def _try_npz(name: str):
    root = os.environ.get("KERAS_DATA_DIR",
                          os.path.expanduser("~/.keras/datasets"))
    path = os.path.join(root, name)
    if os.path.exists(path):
        return np.load(path, allow_pickle=True)
    return None


class mnist:
    @staticmethod
    def load_data(n_train: int = 8192, n_test: int = 1024, seed: int = 0):
        d = _try_npz("mnist.npz")
        if d is not None:
            return (d["x_train"], d["y_train"]), (d["x_test"], d["y_test"])
        xtr, ytr = _synthetic_classification(n_train, (28, 28), 10, seed)
        xte, yte = _synthetic_classification(n_test, (28, 28), 10, seed + 1)
        return (((xtr * 255).astype(np.uint8), ytr),
                ((xte * 255).astype(np.uint8), yte))


class cifar10:
    @staticmethod
    def load_data(n_train: int = 8192, n_test: int = 1024, seed: int = 0):
        d = _try_npz("cifar10.npz")
        if d is not None:
            return (d["x_train"], d["y_train"]), (d["x_test"], d["y_test"])
        xtr, ytr = _synthetic_classification(n_train, (32, 32, 3), 10, seed)
        xte, yte = _synthetic_classification(n_test, (32, 32, 3), 10, seed + 1)
        return (
            ((xtr * 255).astype(np.uint8), ytr[:, None]),
            ((xte * 255).astype(np.uint8), yte[:, None]),
        )


class reuters:
    @staticmethod
    def load_data(num_words: int = 10000, n_train: int = 8192,
                  n_test: int = 1024, maxlen: int = 80, seed: int = 0):
        rng = np.random.RandomState(seed)
        xtr = rng.randint(1, num_words, (n_train, maxlen)).astype(np.int64)
        ytr = rng.randint(0, 46, (n_train,)).astype(np.int64)
        xte = rng.randint(1, num_words, (n_test, maxlen)).astype(np.int64)
        yte = rng.randint(0, 46, (n_test,)).astype(np.int64)
        return (xtr, ytr), (xte, yte)
