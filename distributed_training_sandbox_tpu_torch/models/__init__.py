from .mlp import (PP_TOY_SIZES, ZERO_TOY_SIZES, init_mlp, mlp_apply,
                  mse_loss, pp_toy_mlp, zero_toy_mlp)
from .transformer import (SMOLLM3_3B, SMOLLM3_3B_L8, TINY_LM,
                          TransformerConfig, forward, init_params, lm_loss,
                          model_flops_per_token)

__all__ = ["SMOLLM3_3B", "SMOLLM3_3B_L8", "TINY_LM", "TransformerConfig",
           "MODEL_REGISTRY", "forward", "init_params", "lm_loss",
           "model_flops_per_token", "PP_TOY_SIZES", "ZERO_TOY_SIZES",
           "init_mlp", "mlp_apply", "mse_loss", "pp_toy_mlp", "zero_toy_mlp"]

# CLI name -> TransformerConfig attribute: the JAX package's names for
# the configs the port has
MODEL_REGISTRY = {
    "smollm3-3b": "SMOLLM3_3B",
    "smollm3-3b-l8": "SMOLLM3_3B_L8",
    "tiny": "TINY_LM",
}
