"""Keras backend package (reference: python/flexflow/keras/backend/:
__init__.py `backend()` and backend_functions.py batch_dot/sin/cos/exp/
pow/sum; examples do `from flexflow.keras import backend as K`).
"""
from __future__ import annotations

from ..layers import BatchMatmul, Cos, Exp, Pow, ReduceSum, Sin

_FLOATX = "float32"
_EPSILON = 1e-7
_IMAGE_DATA_FORMAT = "channels_first"  # reference uses NCHW everywhere


def backend() -> str:
    return "flexflow_tpu_torch"


def epsilon() -> float:
    return _EPSILON


def floatx() -> str:
    return _FLOATX


def set_floatx(value: str) -> None:
    global _FLOATX
    if value not in ("float16", "bfloat16", "float32", "float64"):
        raise ValueError(f"floatx {value!r}")
    _FLOATX = value


def image_data_format() -> str:
    return _IMAGE_DATA_FORMAT


def set_image_data_format(value: str) -> None:
    global _IMAGE_DATA_FORMAT
    if value not in ("channels_first", "channels_last"):
        raise ValueError(f"image data format {value!r}")
    _IMAGE_DATA_FORMAT = value


# functional ops (reference: backend_functions.py)

def batch_dot(x, y, name=""):
    return BatchMatmul(name=name)([x, y])


def sin(x, name=""):
    return Sin(name=name)(x)


def cos(x, name=""):
    return Cos(name=name)(x)


def exp(x, name=""):
    return Exp(name=name)(x)


def pow(x, a, name=""):
    return Pow(a, name=name)(x)


def sum(x, axis, keepdims=False, name=""):
    return ReduceSum(axis, keepdims=keepdims, name=name)(x)


from . import internal  # noqa: E402,F401
