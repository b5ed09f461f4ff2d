from .lstm_stack import lstm_stack  # noqa: F401
from .ops import (  # noqa: F401
    PackedStack,
    lstm_stack_forward_fused,
    lstm_stack_op,
    pack_stack,
    pack_stack_cached,
)
from .ref import lstm_stack_ref  # noqa: F401
from .step import lstm_stack_step, lstm_stack_step_op  # noqa: F401
