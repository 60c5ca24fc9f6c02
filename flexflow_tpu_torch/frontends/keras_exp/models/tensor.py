"""Input-tensor descriptor for the experimental Keras frontend (reference:
python/flexflow/keras_exp/models/tensor.py — same role: carry a (batch,
*shape) + dtype spec, create the FFModel tensor, and verify the handle)."""
import numpy as np

from ....ff_types import DataType


_DTYPE_MAP = {
    None: DataType.DT_FLOAT,
    "float32": DataType.DT_FLOAT,
    "float64": DataType.DT_DOUBLE,
    "int32": DataType.DT_INT32,
    "int64": DataType.DT_INT64,
}


def _to_dtype(dtype) -> DataType:
    if isinstance(dtype, DataType):
        return dtype
    if dtype in _DTYPE_MAP:
        return _DTYPE_MAP[dtype]
    # tf.DType / np.dtype objects expose .name / str() as "float32" etc.
    name = getattr(dtype, "name", None) or str(np.dtype(dtype))
    assert name in _DTYPE_MAP, f"unsupported keras_exp dtype {dtype!r}"
    return _DTYPE_MAP[name]


class Tensor:
    def __init__(self, ffconfig=None, key=0, shape=None, batch_shape=None,
                 dtype=None):
        self._ffhandle = None
        self.dtype = _to_dtype(dtype)
        if batch_shape is not None:
            self.batch_shape = tuple(batch_shape)
        else:
            # keras Input shapes lead with None (symbolic batch); substitute
            # the compiled batch size
            self.batch_shape = (ffconfig.batch_size,) + tuple(shape[1:])
        self.num_dims = len(self.batch_shape)
        self.key = key

    @property
    def ffhandle(self):
        return self._ffhandle

    @ffhandle.setter
    def ffhandle(self, handle):
        assert self._ffhandle is None, "[Tensor]: handle already set"
        self._ffhandle = handle
        self._verify()

    @property
    def dtype_str(self) -> str:
        return {v: k for k, v in _DTYPE_MAP.items() if k}[self.dtype]

    def create_ff_tensor(self, ffmodel):
        assert self.batch_shape[0], "[Tensor]: batch size is not set"
        self._ffhandle = ffmodel.create_tensor(list(self.batch_shape),
                                               self.dtype)
        self._verify()
        return self._ffhandle

    def set_batch_size(self, size):
        self.batch_shape = (size,) + self.batch_shape[1:]

    def _verify(self):
        assert tuple(self._ffhandle.dims) == self.batch_shape, (
            f"[Tensor]: shape mismatch {self._ffhandle.dims} vs "
            f"{self.batch_shape}"
        )
        assert self._ffhandle.data_type == self.dtype
