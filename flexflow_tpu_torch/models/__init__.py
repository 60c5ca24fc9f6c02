from .alexnet import AlexNet, build_alexnet  # noqa: F401
from .bert import BertEncoder  # noqa: F401
from .resnet import (bottleneck_block, build_resnet,  # noqa: F401
                     build_resnext50, resnext_block)
from .transformer import build_transformer, create_attention_encoder  # noqa: F401
