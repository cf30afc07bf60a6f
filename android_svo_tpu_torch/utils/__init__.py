"""Per-stage timing and device tracing (`profiling.py`)."""
