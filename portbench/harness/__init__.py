"""The general harness: spec loading, the measured loop, the trace."""
