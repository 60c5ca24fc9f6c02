from .transformer import build_transformer, create_attention_encoder  # noqa: F401
