"""Calibration metrics (ECE / MCE): port of ``iif_tpu/engine/
calibration.py``, NumPy on the host. Equal-width, right-closed confidence
bins (the b-th is (b / n, (b + 1) / n]; a confidence of 0 falls in
none), per-bin accuracy, confidence and count, and the count-weighted
ECE and the MCE. ``plot_reliability_diagram`` imports matplotlib only
when called."""
from __future__ import annotations

from typing import Dict

import numpy as np


def compute_calibration(true_labels: np.ndarray, pred_labels: np.ndarray,
                        confidences: np.ndarray, num_bins: int = 10
                        ) -> Dict[str, np.ndarray]:
    """Per-bin accuracies, confidences and counts, the bin edges, the
    average accuracy and confidence, ECE and MCE."""
    true_labels = np.asarray(true_labels)
    pred_labels = np.asarray(pred_labels)
    confidences = np.asarray(confidences, dtype=np.float64)
    assert len(confidences) == len(pred_labels) == len(true_labels)
    bins = np.linspace(0.0, 1.0, num_bins + 1)
    idx = np.digitize(confidences, bins, right=True) - 1
    in_range = (idx >= 0) & (idx < num_bins)
    idx = idx[in_range]

    bin_counts = np.bincount(idx, minlength=num_bins)
    conf_sums = np.bincount(idx, weights=confidences[in_range],
                            minlength=num_bins)
    hit = (true_labels == pred_labels).astype(np.float64)
    acc_sums = np.bincount(idx, weights=hit[in_range], minlength=num_bins)

    safe = np.maximum(bin_counts, 1)
    bin_accuracies = np.where(bin_counts > 0, acc_sums / safe, 0.0)
    bin_confidences = np.where(bin_counts > 0, conf_sums / safe, 0.0)

    n = max(bin_counts.sum(), 1)
    gaps = np.abs(bin_accuracies - bin_confidences)
    return {
        "accuracies": bin_accuracies,
        "confidences": bin_confidences,
        "counts": bin_counts.astype(int),
        "bins": bins,
        "avg_accuracy": float((bin_accuracies * bin_counts).sum() / n),
        "avg_confidence": float((bin_confidences * bin_counts).sum() / n),
        "expected_calibration_error": float((gaps * bin_counts).sum() / n),
        "max_calibration_error": float(gaps.max() if gaps.size else 0.0),
    }


def plot_reliability_diagram(true_labels, pred_labels, confidences,
                             num_bins: int = 10,
                             title: str = "Reliability Diagram",
                             out_path: str | None = None):
    """The reliability diagram (bars of accuracy and of the gap to the
    confidence, the diagonal); needs matplotlib."""
    import matplotlib.pyplot as plt

    cal = compute_calibration(true_labels, pred_labels, confidences,
                              num_bins)
    centers = (cal["bins"][:-1] + cal["bins"][1:]) / 2
    widths = np.diff(cal["bins"])
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.bar(centers, cal["accuracies"], width=widths, edgecolor="k",
           alpha=0.7, label="accuracy")
    ax.bar(centers, cal["confidences"] - cal["accuracies"],
           bottom=cal["accuracies"], width=widths, color="r", alpha=0.3,
           label="gap")
    ax.plot([0, 1], [0, 1], "k--")
    ax.set_xlabel("confidence")
    ax.set_ylabel("accuracy")
    ax.set_title(f"{title} (ECE={cal['expected_calibration_error']:.4f})")
    ax.legend()
    if out_path:
        fig.savefig(out_path, bbox_inches="tight")
    return fig
