from .profiling import PhaseTimer, annotate, device_trace

__all__ = ["PhaseTimer", "device_trace", "annotate"]
