from .packing import (make_packed_dataset, pack_tokens, packed_batches,
                      synthetic_token_stream)

__all__ = ["make_packed_dataset", "pack_tokens", "packed_batches",
           "synthetic_token_stream"]
