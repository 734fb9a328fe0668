from .transformer import SMOLLM3_3B, TINY_LM, TransformerConfig, init_params

__all__ = ["SMOLLM3_3B", "TINY_LM", "TransformerConfig", "init_params"]
