from .ops import ssd_decode_step, ssd_scan_op  # noqa: F401
from .ref import ssd_scan_ref  # noqa: F401
from .ssd_scan import ssd_chunked, ssd_scan  # noqa: F401
