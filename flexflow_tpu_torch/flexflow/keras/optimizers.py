"""reference python/flexflow/keras/optimizers.py surface."""
from flexflow_tpu_torch.frontends.keras.optimizers import *  # noqa: F401,F403
