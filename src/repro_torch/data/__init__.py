"""Synthetic time-series data."""
