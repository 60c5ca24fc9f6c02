"""Loss functions.

The PyTorch counterpart of flexflow_tpu/core/losses.py (reference:
src/loss_functions/): categorical CE, sparse categorical CE, MSE (avg and
sum reduce) and identity, each a scalar function of the model output and
the labels, computed in f32. Autograd gives the gradients the reference
writes by hand.
"""
from __future__ import annotations

import torch

from ..ff_types import LossType


def categorical_crossentropy(logits_or_probs, labels):
    """Labels are one-hot/probabilities of the output's shape. The final
    Softmax op produces probs, so this takes the log of probs, like the
    reference's CE-from-softmax backward."""
    p = logits_or_probs.float().clamp(1e-12, 1.0)
    return -(labels.float() * torch.log(p)).sum(-1).mean()


def sparse_categorical_crossentropy(probs, labels):
    """Labels are int class ids with shape (..., 1) or (...)."""
    if labels.dim() == probs.dim():
        labels = labels[..., 0]
    logp = torch.log(probs.float().clamp(1e-12, 1.0))
    nll = -torch.take_along_dim(logp, labels[..., None].long(), dim=-1)
    return nll.mean()


def mean_squared_error_avg(preds, labels):
    d = preds.float() - labels.float()
    return (d * d).sum(-1).mean()


def mean_squared_error_sum(preds, labels):
    d = preds.float() - labels.float()
    return (d * d).sum()


def identity_loss(preds, labels):
    """reference: LOSS_IDENTITY -- the model output *is* the loss."""
    return preds.float().mean()


_LOSS_FNS = {
    LossType.LOSS_CATEGORICAL_CROSSENTROPY: categorical_crossentropy,
    LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY: sparse_categorical_crossentropy,
    LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE: mean_squared_error_avg,
    LossType.LOSS_MEAN_SQUARED_ERROR_SUM_REDUCE: mean_squared_error_sum,
    LossType.LOSS_IDENTITY: identity_loss,
}

_BY_NAME = {
    "categorical_crossentropy": LossType.LOSS_CATEGORICAL_CROSSENTROPY,
    "sparse_categorical_crossentropy": LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
    "mean_squared_error": LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
    "mse": LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
    "mean_squared_error_sum": LossType.LOSS_MEAN_SQUARED_ERROR_SUM_REDUCE,
    "identity": LossType.LOSS_IDENTITY,
}


def to_loss_type(spec) -> LossType:
    if isinstance(spec, LossType):
        return spec
    return _BY_NAME[spec]


def get_loss_fn(loss_type):
    return _LOSS_FNS[to_loss_type(loss_type)]
