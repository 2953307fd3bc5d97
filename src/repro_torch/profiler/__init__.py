"""Synthetic per-segment model profiles."""
