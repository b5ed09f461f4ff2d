"""LM families of the port: the dense transformer and Mamba-2 (``api.get_model``)."""
