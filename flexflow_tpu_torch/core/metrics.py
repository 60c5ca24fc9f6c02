"""Metrics.

The PyTorch counterpart of flexflow_tpu/core/metrics.py (reference:
src/metrics_functions/): accuracy, categorical CE, sparse categorical CE,
MSE, RMSE and MAE. `Metrics.compute` returns per-batch partials as 0-d f32
tensors on the model's device, summed (not averaged) so that batches fold
exactly; `PerfMetrics.update` folds them on the host.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Sequence

import torch

from ..ff_types import LossType, MetricsType
from . import losses

_BY_NAME = {
    "accuracy": MetricsType.METRICS_ACCURACY,
    "categorical_crossentropy": MetricsType.METRICS_CATEGORICAL_CROSSENTROPY,
    "sparse_categorical_crossentropy": MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY,
    "mean_squared_error": MetricsType.METRICS_MEAN_SQUARED_ERROR,
    "root_mean_squared_error": MetricsType.METRICS_ROOT_MEAN_SQUARED_ERROR,
    "mean_absolute_error": MetricsType.METRICS_MEAN_ABSOLUTE_ERROR,
}


def to_metrics_type(spec) -> MetricsType:
    if isinstance(spec, MetricsType):
        return spec
    return _BY_NAME[spec]


class Metrics:
    """Per-batch metric computation (reference: metrics_functions.h:27-43)."""

    def __init__(self, loss_type: LossType, metrics: Sequence):
        self.loss_type = loss_type
        self.measures: List[MetricsType] = [to_metrics_type(m) for m in metrics]

    def compute(self, preds, labels) -> Dict[str, torch.Tensor]:
        """Summed partials plus `num_samples` and `num_rows`. Metric
        denominators count prediction rows: a per-position output (b, s,
        vocab) scores b*s classifications, as the reference's metrics
        kernels iterate every row; throughput stays per sample."""
        # filled on the device (no host-to-device copy), so a captured
        # train step can compute them
        f32 = dict(dtype=torch.float32, device=preds.device)
        out: Dict[str, torch.Tensor] = {}
        out["num_samples"] = torch.full((), preds.shape[0], **f32)
        rows = 1
        for d in preds.shape[:-1]:
            rows *= d
        out["num_rows"] = torch.full((), rows, **f32)
        pf = preds.float()
        lf = labels if labels.dtype == torch.int32 else labels.float()
        for m in self.measures:
            if m == MetricsType.METRICS_ACCURACY:
                pred_cls = pf.argmax(-1)
                one_hot = (labels.dim() == preds.dim()
                           and labels.shape[-1] == preds.shape[-1]
                           and labels.dtype.is_floating_point)
                if one_hot:
                    true_cls = lf.argmax(-1)
                else:
                    true_cls = labels.reshape(pred_cls.shape).to(pred_cls.dtype)
                out["train_correct"] = (pred_cls == true_cls).float().sum()
            elif m == MetricsType.METRICS_CATEGORICAL_CROSSENTROPY:
                # rows * mean = exact sum over prediction rows
                out["cce_loss"] = rows * losses.categorical_crossentropy(
                    preds, labels)
            elif m == MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY:
                out["sparse_cce_loss"] = \
                    rows * losses.sparse_categorical_crossentropy(preds, labels)
            elif m == MetricsType.METRICS_MEAN_SQUARED_ERROR:
                d = pf - lf
                out["mse_loss"] = (d * d).mean(-1).sum()
            elif m == MetricsType.METRICS_ROOT_MEAN_SQUARED_ERROR:
                d = pf - lf
                out["rmse_loss"] = (d * d).mean(-1).sqrt().sum()
            elif m == MetricsType.METRICS_MEAN_ABSOLUTE_ERROR:
                out["mae_loss"] = (pf - lf).abs().mean(-1).sum()
        return out


@dataclasses.dataclass
class PerfMetrics:
    """Accumulator (reference: metrics_functions.h:44-80 PerfMetrics)."""

    train_all: int = 0
    train_rows: int = 0  # prediction rows (== train_all for 2D logits)
    train_correct: int = 0
    tracks_accuracy: bool = False
    cce_loss: float = 0.0
    sparse_cce_loss: float = 0.0
    mse_loss: float = 0.0
    rmse_loss: float = 0.0
    mae_loss: float = 0.0
    start_time: float = dataclasses.field(default_factory=time.time)

    def update(self, partials: Dict[str, float]):
        n = int(partials.get("num_samples", 0))
        self.train_all += n
        self.train_rows += int(partials.get("num_rows", n))
        if "train_correct" in partials:
            self.tracks_accuracy = True
            self.train_correct += int(partials["train_correct"])
        for k in ("cce_loss", "sparse_cce_loss", "mse_loss", "rmse_loss",
                  "mae_loss"):
            if k in partials:
                setattr(self, k, getattr(self, k) + float(partials[k]))

    def get_accuracy(self) -> float:
        return 100.0 * self.train_correct / max(1, self.train_rows)

    def report(self) -> str:
        """reference: PerfMetrics::print"""
        elapsed = time.time() - self.start_time
        tp = self.train_all / elapsed if elapsed > 0 else 0.0
        parts = [f"throughput: {tp:.2f} samples/s"]
        rows = max(1, self.train_rows)
        if self.train_all:
            if self.tracks_accuracy:
                parts.append(
                    f"accuracy: {self.get_accuracy():.2f}% "
                    f"({self.train_correct}/{self.train_rows})")
            if self.sparse_cce_loss:
                parts.append(f"sparse_cce: {self.sparse_cce_loss / rows:.4f}")
            if self.cce_loss:
                parts.append(f"cce: {self.cce_loss / rows:.4f}")
            if self.mse_loss:
                parts.append(f"mse: {self.mse_loss / rows:.4f}")
        return "[Metrics] " + " ".join(parts)
