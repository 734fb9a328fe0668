from .classification import (classification_batches,
                             make_classification_examples, pad_collate,
                             shard_examples, synthetic_pair_examples)
from .packing import (CORPUS_HOLDOUT_FRAC, CORPUS_HOLDOUT_MIN_WINDOWS,
                      VocabMismatchError, corpus_holdout_split,
                      get_corpus_tokens, load_corpus_tokenizer,
                      make_packed_dataset, pack_tokens, packed_batches,
                      read_corpus_documents, synthetic_token_stream,
                      tokenize_documents)

__all__ = ["make_packed_dataset", "pack_tokens", "packed_batches",
           "synthetic_token_stream", "tokenize_documents",
           "read_corpus_documents", "load_corpus_tokenizer",
           "get_corpus_tokens", "corpus_holdout_split", "VocabMismatchError",
           "CORPUS_HOLDOUT_FRAC", "CORPUS_HOLDOUT_MIN_WINDOWS",
           "classification_batches", "make_classification_examples",
           "pad_collate", "shard_examples", "synthetic_pair_examples"]
