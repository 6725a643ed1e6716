"""Stage timers, the profiler trace, device selection and the native
builds."""
from .profiling import (device_trace, print_report, report,  # noqa: F401
                        stage_timer)
