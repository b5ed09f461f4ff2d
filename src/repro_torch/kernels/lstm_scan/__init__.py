from .lstm_scan import lstm_scan, lstm_scan_layer  # noqa: F401
from .ops import lstm_forward_kernel, lstm_scan_op, pad_gates  # noqa: F401
from .ref import lstm_scan_layer_ref, lstm_scan_ref  # noqa: F401
