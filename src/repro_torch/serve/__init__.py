"""Batch and streaming anomaly-scoring engines."""
