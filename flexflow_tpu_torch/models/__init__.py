from .alexnet import AlexNet, build_alexnet  # noqa: F401
from .bert import BertEncoder  # noqa: F401
from .dlrm import build_dlrm  # noqa: F401
from .inception import build_inception_v3  # noqa: F401
from .misc import (build_bert_proxy, build_candle_uno,  # noqa: F401
                   build_mlp_unify, build_moe, build_xdl)
from .resnet import (bottleneck_block, build_resnet,  # noqa: F401
                     build_resnext50, resnext_block)
from .transformer import build_transformer, create_attention_encoder  # noqa: F401
from .zoo import build_moe_transformer  # noqa: F401
