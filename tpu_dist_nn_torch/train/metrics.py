"""Evaluation metrics matching the reference toolchain's report.

The reference notebook scores accuracy, precision, recall, and F1 with
sklearn's weighted averaging and embeds them in the exported model JSON
(cell 9-10: acc 0.9685 · precision 0.9691 · recall 0.9685 · F1 0.9686).
Implemented natively in numpy so the framework carries no sklearn
dependency.
"""

from __future__ import annotations

import numpy as np


def accuracy(predictions: np.ndarray, labels: np.ndarray) -> float:
    """argmax-vs-label accuracy (run_grpc_inference.py:191-194)."""
    predictions = np.asarray(predictions)
    if predictions.ndim == 2:
        predictions = predictions.argmax(-1)
    return float((predictions == np.asarray(labels)).mean())


def classification_metrics(
    predictions: np.ndarray, labels: np.ndarray, num_classes: int | None = None
) -> dict:
    """Weighted-average precision/recall/F1 + accuracy (notebook cell 9).

    Weighted averaging (per-class metrics weighted by true-class support)
    reproduces sklearn's ``average="weighted"`` — the reference's recall
    equals its accuracy, which is the weighted-averaging signature.
    """
    predictions = np.asarray(predictions)
    if predictions.ndim == 2:
        predictions = predictions.argmax(-1)
    labels = np.asarray(labels)
    if num_classes is None:
        num_classes = int(max(predictions.max(), labels.max())) + 1

    precision = np.zeros(num_classes)
    recall = np.zeros(num_classes)
    f1 = np.zeros(num_classes)
    support = np.zeros(num_classes)
    for c in range(num_classes):
        tp = float(((predictions == c) & (labels == c)).sum())
        fp = float(((predictions == c) & (labels != c)).sum())
        fn = float(((predictions != c) & (labels == c)).sum())
        support[c] = (labels == c).sum()
        precision[c] = tp / (tp + fp) if tp + fp else 0.0
        recall[c] = tp / (tp + fn) if tp + fn else 0.0
        denom = precision[c] + recall[c]
        f1[c] = 2 * precision[c] * recall[c] / denom if denom else 0.0

    total = support.sum()
    weights = support / total if total else support
    return {
        "accuracy": float((predictions == labels).mean()),
        "precision": float((precision * weights).sum()),
        "recall": float((recall * weights).sum()),
        "f1_score": float((f1 * weights).sum()),
    }
