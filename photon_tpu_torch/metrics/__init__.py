"""Metric history."""
