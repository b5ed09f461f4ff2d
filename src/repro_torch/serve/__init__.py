"""Serving: engines, the stream server, latency statistics, health and snapshots."""
