"""Analytic queueing model and the Algorithm 1 planner (host NumPy)."""
