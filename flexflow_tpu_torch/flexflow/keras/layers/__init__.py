"""reference python/flexflow/keras/layers/ (every layer class)."""
from flexflow_tpu_torch.frontends.keras.layers import *  # noqa: F401,F403
