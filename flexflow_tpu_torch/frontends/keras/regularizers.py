"""Keras-style weight regularizers (reference: python/flexflow/keras/
regularizers.py:19-36). L2 matches the reference's only supported mode
(linear_kernels.cu:333-350); L1 is the JAX package's addition. Either
penalty joins the training loss (parallel/executor.py _reg_penalty).
"""
from __future__ import annotations

from ...ff_types import RegularizerMode

__all__ = ["Regularizer", "L1", "L2"]


class Regularizer:
    def __init__(self):
        self.type: RegularizerMode = RegularizerMode.REG_MODE_NONE
        self._lambda: float = 0.0


class L1(Regularizer):
    def __init__(self, l1: float):
        super().__init__()
        self.type = RegularizerMode.REG_MODE_L1
        self._lambda = l1


class L2(Regularizer):
    def __init__(self, l2: float):
        super().__init__()
        self.type = RegularizerMode.REG_MODE_L2
        self._lambda = l2
