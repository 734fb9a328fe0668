from .flash_prefill import paged_flash_prefill, paged_flash_prefill_plain
from .paged_attention import paged_attention_decode, paged_attention_plain

__all__ = ["paged_attention_decode", "paged_attention_plain",
           "paged_flash_prefill", "paged_flash_prefill_plain"]
