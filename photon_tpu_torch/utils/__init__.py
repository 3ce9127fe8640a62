"""Timing and throughput helpers."""
