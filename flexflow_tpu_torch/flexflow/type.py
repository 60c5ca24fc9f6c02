"""The enum vocabulary (reference: python/flexflow/type.py)."""
from flexflow_tpu_torch.ff_types import (  # noqa: F401
    ActiMode,
    AggrMode,
    CompMode,
    DataType,
    LossType,
    MetricsType,
    OperatorType,
    ParameterSyncType,
    PoolType,
    RegularizerMode,
)

# reference type.py:59 names the operator enum `OpType`
OpType = OperatorType


def enum_to_int(enum_cls, enum_item) -> int:
    """reference type.py:117"""
    return int(enum_item.value)


def int_to_enum(enum_cls, value):
    """reference type.py:127"""
    return enum_cls(value)


def enum_to_str(enum_cls, enum_item) -> str:
    """reference type.py:134"""
    return enum_item.name


def str_to_enum(enum_cls, value):
    """reference type.py:138"""
    return enum_cls[value]
