"""reference python/flexflow/keras/initializers.py surface."""
from flexflow_tpu_torch.frontends.keras.initializers import *  # noqa: F401,F403
