from tagrec_tpu_torch.utils.logging import MetricsWriter, printc
from tagrec_tpu_torch.utils.profiling import (count, enable, snapshot, span,
                                              start_trace, stop_trace, write)

__all__ = ["MetricsWriter", "printc", "span", "count", "enable", "snapshot",
           "write", "start_trace", "stop_trace"]
