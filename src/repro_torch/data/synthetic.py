"""Synthetic MNIST-like dataset for the FL experiments (numpy only).

A copy of ``repro.data.synthetic.make_mnist_like`` and its prototype
generator: the port keeps its own copy rather than import the reference
package. Same seed, same arrays, bit for bit (tests/test_torch_data.py).
Each of 10 classes has a smoothed stroke prototype; samples add a shift of
up to 2 pixels and Gaussian pixel noise, clipped to [0, 1].
"""
from __future__ import annotations

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
