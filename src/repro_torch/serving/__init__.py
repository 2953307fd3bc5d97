"""Traces, the stepper simulator and the real-execution engine."""
