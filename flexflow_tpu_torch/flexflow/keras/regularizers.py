"""reference python/flexflow/keras/regularizers.py surface."""
from flexflow_tpu_torch.frontends.keras.regularizers import *  # noqa: F401,F403
