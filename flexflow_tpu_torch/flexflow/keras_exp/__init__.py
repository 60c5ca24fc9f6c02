"""reference python/flexflow/keras_exp/ (the experimental Keras frontend)."""
from flexflow_tpu_torch.frontends.keras_exp import models  # noqa: F401
