"""`flexflow.core` -- the reference's cffi star-import surface
(python/flexflow/core/flexflow_cffi.py via core/__init__.py) mapped onto
flexflow_tpu_torch: FFConfig, FFModel, Tensor, SingleDataLoader, the
optimizers with the reference's `SGDOptimizer(ffmodel, lr)` signatures,
the initializers and every enum. The reference's Legion bootstrap
(flexflow_top.py) has no counterpart: torch owns the process and its
devices.
"""
from __future__ import annotations

from flexflow_tpu_torch import (  # noqa: F401
    ActiMode,
    AggrMode,
    BatchScheduler,
    CompMode,
    ConstantInitializer,
    DataType,
    FFConfig,
    FFIterationConfig,
    FFModel,
    GlorotUniformInitializer,
    Initializer,
    Layer,
    LossType,
    Metrics,
    MetricsType,
    NormInitializer,
    OneInitializer,
    OperatorType,
    Optimizer,
    ParameterSyncType,
    PerfMetrics,
    PoolType,
    SingleDataLoader,
    Tensor,
    UniformInitializer,
    ZeroInitializer,
    restore_checkpoint,
    save_checkpoint,
)
from flexflow_tpu_torch.core.optimizers import (
    AdamOptimizer as _CoreAdam,
    SGDOptimizer as _CoreSGD,
)
from flexflow_tpu_torch.ff_types import RegularizerMode  # noqa: F401

from .flexflow_logger import fflogger  # noqa: F401


def _drop_ffmodel(args):
    """The reference cffi optimizers take the FFModel as first argument
    (flexflow_cffi.py SGDOptimizer(ffmodel, ...)); the port's are
    model-free dataclasses. Accept both calling conventions."""
    if args and isinstance(args[0], FFModel):
        return args[1:]
    return args


class SGDOptimizer(_CoreSGD):
    """reference cffi: SGDOptimizer(ffmodel, lr, momentum, nesterov, wd)."""

    def __init__(self, *args, **kw):
        args = _drop_ffmodel(args)
        super().__init__(*args, **kw)


class AdamOptimizer(_CoreAdam):
    """reference cffi: AdamOptimizer(ffmodel, alpha, beta1, beta2, wd, eps)."""

    def __init__(self, *args, **kw):
        args = _drop_ffmodel(args)
        super().__init__(*args, **kw)


def get_legion_runtime():
    """Legion runtime handle (reference flexflow_cffi). No Legion here."""
    return None


def init_flexflow_runtime(*a, **kw):
    """reference: starts the Legion runtime. torch needs no explicit start."""
    return None
