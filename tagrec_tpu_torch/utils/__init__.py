from tagrec_tpu_torch.utils.logging import MetricsWriter, printc
from tagrec_tpu_torch.utils.profiling import (StepTimer, trace, start_trace,
                                              stop_trace)

__all__ = ["MetricsWriter", "printc", "StepTimer", "trace", "start_trace",
           "stop_trace"]
