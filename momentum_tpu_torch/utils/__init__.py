from momentum_tpu_torch.utils.profiling import profile_scope, start_trace, stop_trace  # noqa: F401
from momentum_tpu_torch.utils.logging import get_logger, set_log_level  # noqa: F401
