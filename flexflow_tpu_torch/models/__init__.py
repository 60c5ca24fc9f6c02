from .bert import BertEncoder  # noqa: F401
from .transformer import build_transformer, create_attention_encoder  # noqa: F401
