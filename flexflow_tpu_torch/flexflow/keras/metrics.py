"""reference python/flexflow/keras/metrics.py surface."""
from flexflow_tpu_torch.frontends.keras.metrics import *  # noqa: F401,F403
