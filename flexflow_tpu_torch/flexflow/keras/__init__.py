"""`flexflow.keras` -- the reference's Keras-compatible frontend
namespace (python/flexflow/keras/__init__.py) mapped onto
flexflow_tpu_torch.frontends.keras."""
from flexflow_tpu_torch.frontends.keras import (  # noqa: F401
    Activation,
    Add,
    AveragePooling2D,
    BatchNormalization,
    Concatenate,
    Conv2D,
    Dense,
    Dropout,
    Embedding,
    Flatten,
    Input,
    LayerNormalization,
    Maximum,
    MaxPooling2D,
    Minimum,
    Model,
    MultiHeadAttention,
    Multiply,
    Permute,
    Reshape,
    Sequential,
    Subtract,
)
from . import (  # noqa: F401
    backend,
    callbacks,
    datasets,
    initializers,
    layers,
    losses,
    metrics,
    models,
    optimizers,
    regularizers,
)
