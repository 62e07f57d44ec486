from .profiling import PhaseTimer, annotate, count, device_trace, span, spanned, spans

__all__ = ["PhaseTimer", "device_trace", "annotate", "span", "spanned", "count", "spans"]
