"""reference python/flexflow/keras_exp/models/__init__.py"""
from flexflow_tpu_torch.frontends.keras_exp.models import (  # noqa: F401
    BaseModel,
    Model,
    Sequential,
    Tensor,
)
