"""reference python/flexflow/keras/datasets/ (mnist, cifar10, reuters):
deterministic synthetic datasets unless a local .npz is found, with the
Keras originals' shapes and dtypes."""
from flexflow_tpu_torch.frontends.keras.datasets import (  # noqa: F401
    cifar10,
    mnist,
    reuters,
)
