"""Host spans and counters, per-frame timers and device tracing
(`profiling.py`)."""
