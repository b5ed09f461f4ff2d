"""Core of the port: numerics, the LSTM cell, packing, plans, the autoencoder."""
