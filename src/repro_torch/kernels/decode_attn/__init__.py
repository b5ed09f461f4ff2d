from .decode_attn import decode_attn, decode_attn_plain  # noqa: F401
from .ops import decode_attn_op  # noqa: F401
from .ref import decode_attn_ref  # noqa: F401
