"""Synthetic MNIST-like dataset for the FL experiments (numpy only).

A copy of ``repro.data.synthetic.make_mnist_like`` and its prototype
generator: the port keeps its own copy rather than import the reference
package. Same seed, same arrays, bit for bit (tests/test_torch_data.py).
Each of 10 classes has a smoothed stroke prototype; samples add a shift of
up to 2 pixels and Gaussian pixel noise, clipped to [0, 1].

``get_dataset`` reads a local ``mnist.npz`` when one is present and falls
back to ``make_mnist_like`` otherwise, as the reference does; nothing is
downloaded.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def _class_prototypes(n_classes: int, side: int, rng) -> np.ndarray:
    """Smoothed random stroke patterns, one per class — stable, separable."""
    protos = np.zeros((n_classes, side, side), np.float32)
    for c in range(n_classes):
        img = np.zeros((side, side), np.float32)
        # draw 3 random strokes (line segments) per class
        for _ in range(3):
            x0, y0 = rng.integers(4, side - 4, 2)
            ang = rng.uniform(0, 2 * np.pi)
            length = rng.integers(8, side - 6)
            for t in np.linspace(0, 1, 60):
                x = int(np.clip(x0 + np.cos(ang) * t * length, 0, side - 1))
                y = int(np.clip(y0 + np.sin(ang) * t * length, 0, side - 1))
                img[y, x] = 1.0
        # box-blur twice for stroke thickness
        for _ in range(2):
            img = (img
                   + np.roll(img, 1, 0) + np.roll(img, -1, 0)
                   + np.roll(img, 1, 1) + np.roll(img, -1, 1)) / 5.0
        protos[c] = img / max(img.max(), 1e-6)
    return protos


def make_mnist_like(n_train: int = 20000, n_test: int = 4000,
                    n_classes: int = 10, side: int = 28, noise: float = 0.25,
                    seed: int = 1234) -> Tuple[np.ndarray, np.ndarray,
                                               np.ndarray, np.ndarray]:
    """Returns (x_train (N,784) float32 in [0,1], y_train, x_test, y_test)."""
    rng = np.random.default_rng(seed)
    protos = _class_prototypes(n_classes, side, rng)

    def gen(n):
        y = rng.integers(0, n_classes, n).astype(np.int32)
        x = np.empty((n, side * side), np.float32)
        shifts = rng.integers(-2, 3, size=(n, 2))
        for i in range(n):
            img = protos[y[i]]
            img = np.roll(img, shifts[i, 0], axis=0)
            img = np.roll(img, shifts[i, 1], axis=1)
            img = img + noise * rng.standard_normal(
                (side, side)).astype(np.float32)
            x[i] = np.clip(img, 0.0, 1.0).reshape(-1)
        return x, y

    x_tr, y_tr = gen(n_train)
    x_te, y_te = gen(n_test)
    return x_tr, y_tr, x_te, y_te


def load_mnist_npz(path: str = "mnist.npz"):
    """Real MNIST from a local .npz with x_train/y_train/x_test/y_test (the
    ``make_mnist_like`` interface), or None if the file is absent."""
    if not os.path.exists(path):
        return None
    z = np.load(path)
    x_tr = z["x_train"].reshape(len(z["x_train"]), -1).astype(
        np.float32) / 255.0
    x_te = z["x_test"].reshape(len(z["x_test"]), -1).astype(
        np.float32) / 255.0
    return (x_tr, z["y_train"].astype(np.int32), x_te,
            z["y_test"].astype(np.int32))


def get_dataset(prefer_real: bool = True, **kw):
    if prefer_real:
        real = load_mnist_npz()
        if real is not None:
            return real
    return make_mnist_like(**kw)


# ---------------------------------------------------------------------------
# synthetic LM tokens (the train CLI, the LM training tests)
# ---------------------------------------------------------------------------

def token_stream(vocab: int, batch: int, seq: int, n_batches: int,
                 seed: int = 0):
    """Markov-ish synthetic token batches: next token = (prev*a + c) % vocab
    with noise — learnable structure, zero storage. A copy of the
    reference's ``token_stream``: the same seed gives the same int32
    batches, bit for bit."""
    rng = np.random.default_rng(seed)
    a = 31 % vocab or 1
    for _ in range(n_batches):
        x = np.empty((batch, seq), np.int64)
        x[:, 0] = rng.integers(0, vocab, batch)
        flip = rng.random((batch, seq)) < 0.1
        for t in range(1, seq):
            nxt = (x[:, t - 1] * a + 7) % vocab
            x[:, t] = np.where(flip[:, t], rng.integers(0, vocab, batch), nxt)
        yield {"tokens": x.astype(np.int32)}
