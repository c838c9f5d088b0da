from .ops import ROUTES, attend, flash_attention, route
from .ref import attend_chunked, attention_ref, flash_attention_ref
