"""Parallel axes of the receiver (time-block parallel tracking)."""
