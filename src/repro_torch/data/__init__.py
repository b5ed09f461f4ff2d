"""Synthetic data (numpy): GW strain (``gw``) and LM token streams (``lm``)."""
