"""The paper's own models: LSTM autoencoders for GW anomaly detection.

``gw_small``   2 LSTM layers x 9 hidden (paper Table II Z*).
``gw_nominal`` 4 LSTM layers 32, 8, 8, 32 + TimeDistributed dense (U*).
"""

from repro_torch.core.autoencoder import AutoencoderConfig

GW_MODELS = {
    "gw_small": AutoencoderConfig(hidden=(9, 9), latent_boundary=1, timesteps=100),
    "gw_nominal": AutoencoderConfig(hidden=(32, 8, 8, 32), timesteps=100),
}
