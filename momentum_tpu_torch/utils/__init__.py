from momentum_tpu_torch.utils.profiling import (  # noqa: F401
    host_sync, profile_scope, spanned, start_trace, stop_trace)
from momentum_tpu_torch.utils.logging import get_logger, set_log_level  # noqa: F401
