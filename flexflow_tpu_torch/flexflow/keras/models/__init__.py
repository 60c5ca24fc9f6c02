"""reference python/flexflow/keras/models/ (Model, Sequential)."""
from flexflow_tpu_torch.frontends.keras.models import Model, Sequential  # noqa: F401
from flexflow_tpu_torch.frontends.keras.layers import Input  # noqa: F401
