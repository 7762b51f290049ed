"""Timers and metrics logging."""
