"""reference python/flexflow/keras/backend/internal.py."""
from flexflow_tpu_torch.frontends.keras.backend.internal import *  # noqa: F401,F403
from flexflow_tpu_torch.frontends.keras.backend.internal import gather, rsqrt  # noqa: F401
