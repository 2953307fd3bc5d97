"""Partitionable CNNs for real execution."""
