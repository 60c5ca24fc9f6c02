"""reference python/flexflow/keras/callbacks.py surface."""
from flexflow_tpu_torch.frontends.keras.callbacks import *  # noqa: F401,F403
