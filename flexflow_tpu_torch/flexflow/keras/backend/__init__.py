"""reference python/flexflow/keras/backend/."""
from flexflow_tpu_torch.frontends.keras.backend import *  # noqa: F401,F403
from flexflow_tpu_torch.frontends.keras.backend import (  # noqa: F401
    backend, batch_dot, cos, epsilon, exp, floatx, image_data_format,
    internal, pow, set_floatx, set_image_data_format, sin, sum,
)
