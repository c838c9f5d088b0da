from .ops import attend, flash_attention
from .ref import attend_chunked, attention_ref, flash_attention_ref
