from .mlp import (PP_TOY_SIZES, ZERO_TOY_SIZES, init_mlp, mlp_apply,
                  mse_loss, pp_toy_mlp, zero_toy_mlp)
from .transformer import (CORPUS_350M, CORPUS_LM, LLAMA31_8B, LLAMA32_1B,
                          QWEN3_4B, QWEN3_4B_L6, SMOLLM3_350M, SMOLLM3_3B,
                          SMOLLM3_3B_L8, TINY_LM, TINY_LM_L8,
                          TransformerConfig, forward, init_params, lm_loss,
                          model_flops_per_token)
from .classifier import (classification_accuracy, classification_loss,
                         classifier_logits, init_classifier_params)

__all__ = ["SMOLLM3_3B", "SMOLLM3_3B_L8", "SMOLLM3_350M", "QWEN3_4B",
           "QWEN3_4B_L6", "LLAMA32_1B", "LLAMA31_8B", "TINY_LM",
           "TINY_LM_L8", "CORPUS_LM", "CORPUS_350M", "TransformerConfig",
           "MODEL_REGISTRY", "forward", "init_params", "lm_loss",
           "model_flops_per_token", "init_classifier_params",
           "classifier_logits", "classification_loss",
           "classification_accuracy", "PP_TOY_SIZES", "ZERO_TOY_SIZES",
           "init_mlp", "mlp_apply", "mse_loss", "pp_toy_mlp", "zero_toy_mlp"]

# CLI name -> TransformerConfig attribute: the JAX package's registry,
# name for name
MODEL_REGISTRY = {
    "smollm3-3b": "SMOLLM3_3B",
    "smollm3-3b-l8": "SMOLLM3_3B_L8",
    "smollm3-350m": "SMOLLM3_350M",
    "qwen3-4b": "QWEN3_4B",
    "qwen3-4b-l6": "QWEN3_4B_L6",
    "llama3.2-1b": "LLAMA32_1B",
    "llama3.1-8b": "LLAMA31_8B",
    "tiny": "TINY_LM",
    "tiny8": "TINY_LM_L8",
    "corpus-70m": "CORPUS_LM",
    "corpus-350m": "CORPUS_350M",
}
