"""Metric logging and the step timer."""
