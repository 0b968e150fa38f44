"""Evaluation and experiment records for the FL experiments, torch form.

Port of ``repro.fl.metrics``: ``evaluate`` runs the model on the device in
batches and counts on the host; ``time_to_accuracy`` (Table I) and
``write_csv`` are copies.
"""
from __future__ import annotations

import csv
import os
from typing import Callable, List

import numpy as np
import torch


def evaluate(params, x_test: np.ndarray, y_test: np.ndarray,
             apply_fn: Callable, batch: int = 1024) -> dict:
    """Test accuracy and mean cross-entropy of ``params`` (a params dict on
    the device that runs the model)."""
    leaf = params
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    dev = leaf.device
    correct, total, loss_sum = 0, 0, 0.0
    with torch.no_grad():
        for i in range(0, len(y_test), batch):
            xb = torch.as_tensor(x_test[i:i + batch], device=dev)
            yb = torch.as_tensor(y_test[i:i + batch], device=dev).long()
            logits = apply_fn(params, xb)
            correct += int((logits.argmax(-1) == yb).sum())
            lse = torch.logsumexp(logits, dim=-1)
            ll = logits.gather(-1, yb[:, None])[:, 0]
            loss_sum += float((lse - ll).sum())
            total += len(yb)
    return {"accuracy": correct / total, "loss": loss_sum / total}


def time_to_accuracy(history: List[dict], targets=(0.5, 0.6, 0.7, 0.8)):
    """Table I: the first (round, time) reaching each target accuracy."""
    out = {}
    for tgt in targets:
        hit = next((h for h in history if h.get("accuracy", 0) >= tgt), None)
        out[tgt] = (hit["round"], hit["time"]) if hit else (None, None)
    return out


def write_csv(path: str, rows: List[dict]):
    if not rows:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    keys = sorted({k for r in rows for k in r})
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        for r in rows:
            w.writerow(r)
