"""Discrete-event simulator, job records and metrics."""
