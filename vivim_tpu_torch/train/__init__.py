"""Metrics (training comes with a later slice)."""
