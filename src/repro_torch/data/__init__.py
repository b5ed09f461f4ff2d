"""Synthetic GW strain data (numpy)."""
