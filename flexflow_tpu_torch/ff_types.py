"""Core enums and type maps for flexflow_tpu_torch.

The PyTorch counterpart of flexflow_tpu/ff_types.py: the same enum names
and values, so op names, params and weights line up one to one between
the two packages. `DataType` maps to torch dtypes where the JAX package
maps to jnp dtypes.
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch


class DataType(enum.IntEnum):
    """Tensor element types (reference: ffconst.h:14-21)."""

    DT_BOOLEAN = 40
    DT_INT32 = 41
    DT_INT64 = 42
    DT_HALF = 43
    DT_FLOAT = 44
    DT_DOUBLE = 45
    DT_BF16 = 46
    DT_NONE = 49

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DT_TO_TORCH[self]

    @property
    def np_dtype(self):
        """numpy has no bfloat16: DT_BF16 values cross to the host as
        float32."""
        return _DT_TO_NP[self]

    @property
    def size(self) -> int:
        return _DT_TO_TORCH[self].itemsize


_DT_TO_TORCH = {
    DataType.DT_BOOLEAN: torch.bool,
    DataType.DT_INT32: torch.int32,
    DataType.DT_INT64: torch.int64,
    DataType.DT_HALF: torch.float16,
    DataType.DT_FLOAT: torch.float32,
    DataType.DT_DOUBLE: torch.float64,
    DataType.DT_BF16: torch.bfloat16,
}

_DT_TO_NP = {
    DataType.DT_BOOLEAN: np.bool_,
    DataType.DT_INT32: np.int32,
    DataType.DT_INT64: np.int64,
    DataType.DT_HALF: np.float16,
    DataType.DT_FLOAT: np.float32,
    DataType.DT_DOUBLE: np.float64,
    DataType.DT_BF16: np.float32,
}


def to_data_type(x) -> DataType:
    if isinstance(x, DataType):
        return x
    if isinstance(x, torch.dtype):
        return {v: k for k, v in _DT_TO_TORCH.items()}[x]
    name = np.dtype(x).name
    return {
        "bool": DataType.DT_BOOLEAN,
        "int32": DataType.DT_INT32,
        "int64": DataType.DT_INT64,
        "float16": DataType.DT_HALF,
        "float32": DataType.DT_FLOAT,
        "float64": DataType.DT_DOUBLE,
    }[name]


class ActiMode(enum.IntEnum):
    """Fused activation modes (reference: ffconst.h:23-29)."""

    AC_MODE_NONE = 10
    AC_MODE_RELU = 11
    AC_MODE_SIGMOID = 12
    AC_MODE_TANH = 13
    AC_MODE_GELU = 14


class AggrMode(enum.IntEnum):
    """Embedding aggregation (reference: ffconst.h:31-35)."""

    AGGR_MODE_NONE = 20
    AGGR_MODE_SUM = 21
    AGGR_MODE_AVG = 22


class PoolType(enum.IntEnum):
    """Pooling modes (reference: ffconst.h:37-40)."""

    POOL_MAX = 30
    POOL_AVG = 31


class RegularizerMode(enum.IntEnum):
    REG_MODE_NONE = 25
    REG_MODE_L1 = 26
    REG_MODE_L2 = 27


class LossType(enum.IntEnum):
    """Loss functions (reference: ffconst.h:47-53)."""

    LOSS_CATEGORICAL_CROSSENTROPY = 50
    LOSS_SPARSE_CATEGORICAL_CROSSENTROPY = 51
    LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE = 52
    LOSS_MEAN_SQUARED_ERROR_SUM_REDUCE = 53
    LOSS_IDENTITY = 54


class MetricsType(enum.IntEnum):
    """Metrics ids (reference: ffconst.h:55-63)."""

    METRICS_ACCURACY = 1001
    METRICS_CATEGORICAL_CROSSENTROPY = 1002
    METRICS_SPARSE_CATEGORICAL_CROSSENTROPY = 1004
    METRICS_MEAN_SQUARED_ERROR = 1008
    METRICS_ROOT_MEAN_SQUARED_ERROR = 1016
    METRICS_MEAN_ABSOLUTE_ERROR = 1032


class CompMode(enum.IntEnum):
    """Computation mode (reference: ffconst.h:65-67)."""

    COMP_MODE_TRAINING = 70
    COMP_MODE_INFERENCE = 71


class ParameterSyncType(enum.IntEnum):
    NONE = 80
    PS = 81
    NCCL = 82


class OperatorType(enum.IntEnum):
    """All operator types (reference: ffconst.h:69-163). Values equal the
    JAX package's; only some have an op definition in this package."""

    OP_NOOP = 1000
    OP_INPUT = 1001
    OP_WEIGHT = 1002
    OP_CONV2D = 1010
    OP_DROPOUT = 1011
    OP_LINEAR = 1012
    OP_BATCHMATMUL = 1013
    OP_POOL2D = 1014
    OP_RELU = 1020
    OP_SIGMOID = 1021
    OP_TANH = 1022
    OP_ELU = 1023
    OP_FLAT = 1024
    OP_SOFTMAX = 1025
    OP_BATCHNORM = 1026
    OP_CONCAT = 1027
    OP_SPLIT = 1028
    OP_EMBEDDING = 1029
    OP_GROUP_BY = 1030
    OP_CACHE = 1031
    OP_AGGREGATE = 1032
    OP_AGG_SPEC = 1033
    OP_RESHAPE = 1040
    OP_REVERSE = 1041
    OP_TRANSPOSE = 1042
    OP_EW_ADD = 1043
    OP_EW_MUL = 1044
    OP_MATMUL = 1045
    OP_MUL = 1046
    OP_ENLARGE = 1047
    OP_SQUEEZE = 1048
    OP_UNSQUEEZE = 1049
    OP_EW_SUB = 1050
    OP_EW_DIV = 1051
    OP_EW_EQUAL = 1052
    OP_EW_GREATER = 1053
    OP_EW_LESS = 1054
    OP_EW_MAX = 1055
    OP_EW_MIN = 1056
    OP_REDUCE_ARGMAX = 1057
    OP_REDUCE_ARGMIN = 1058
    OP_REDUCE_MAX = 1059
    OP_REDUCE_MEAN = 1060
    OP_REDUCE_MIN = 1061
    OP_REDUCE_PROD = 1062
    OP_REDUCE_SUM = 1063
    OP_PAD = 1064
    OP_SHAPE = 1065
    OP_SIZE = 1066
    OP_TOPK = 1067
    OP_WHERE = 1068
    OP_CEIL = 1069
    OP_CAST = 1070
    OP_EXP = 1071
    OP_ROUND = 1072
    OP_LOG = 1073
    OP_LOGICAL_NOT = 1074
    OP_SQRT = 1075
    OP_SIN = 1076
    OP_COS = 1077
    OP_LEAKYRELU = 1078
    OP_SLICE = 1079
    OP_RESIZE = 1080
    OP_PRELU = 1081
    OP_GELU = 1082
    OP_MULTIHEAD_ATTENTION = 1090
    OP_FUSED = 1091
    OP_RSQRT = 1092
    OP_POW = 1093
    OP_MEAN = 1094
    OP_LAYERNORM = 1095
    OP_IDENTITY = 1096
    OP_GATHER = 1097
    OP_SCALAR_MULTIPLY = 1101
    OP_SCALAR_ADD = 1102
    OP_SCALAR_SUB = 1103
    OP_SCALAR_FLOOR_DIV = 1104
    OP_SCALAR_TRUE_DIV = 1105
    OP_BLOCK_STACK = 1107
    OP_REPARTITION = 1110
    OP_COMBINE = 1111
    OP_REPLICATE = 1112
    OP_REDUCTION = 1113
    OP_PIPELINE = 1114
    OP_FUSED_PARALLEL = 1115
    OP_ALL_TO_ALL = 1120
    OP_WEIGHT_SHARD = 1121
    OP_LSTM = 1130


# the parallel ops the strategy search inserts (parallel/parallel_ops.py)
PARALLEL_OP_TYPES = frozenset(
    {
        OperatorType.OP_REPARTITION,
        OperatorType.OP_COMBINE,
        OperatorType.OP_REPLICATE,
        OperatorType.OP_REDUCTION,
        OperatorType.OP_PIPELINE,
        OperatorType.OP_FUSED_PARALLEL,
        OperatorType.OP_ALL_TO_ALL,
        OperatorType.OP_WEIGHT_SHARD,
    }
)


class InitializerType(enum.IntEnum):
    """The reference's initializer tags (ffconst.h), as the JAX package
    spells them."""

    INITIALIZER_GLOROT_UNIFORM = 2000
    INITIALIZER_ZERO = 2001
    INITIALIZER_CONSTANT = 2002
    INITIALIZER_UNIFORM = 2003
    INITIALIZER_NORM = 2004


MAX_TENSOR_DIM = 5  # reference: config MAX_TENSOR_DIM (include/flexflow/config.h)


@dataclasses.dataclass
class FFIterationConfig:
    """Per-iteration config (reference: config.h:162-167)."""

    seq_length: int = -1

    def reset(self):
        self.seq_length = -1
