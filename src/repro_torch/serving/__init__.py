"""Geo-serving router over pods that run real decode steps."""
