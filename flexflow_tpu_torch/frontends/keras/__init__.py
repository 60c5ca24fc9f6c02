"""Keras-compatible frontend (reference: python/flexflow/keras/): the
PyTorch counterpart of flexflow_tpu/frontends/keras/."""
from . import (  # noqa: F401
    backend,
    callbacks,
    datasets,
    initializers,
    layers,
    losses,
    metrics,
    optimizers,
    regularizers,
)
from .layers import (  # noqa: F401
    Permute,
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
    MultiHeadAttention,
    Multiply,
    Reshape,
    Subtract,
)
from .models import Model, Sequential  # noqa: F401
from .optimizers import SGD, Adam  # noqa: F401
