"""reference python/flexflow/keras/losses.py surface."""
from flexflow_tpu_torch.frontends.keras.losses import *  # noqa: F401,F403
