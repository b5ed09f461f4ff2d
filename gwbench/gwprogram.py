"""How the benchmark hands the GW autoencoder to the program: its
configuration from a configuration file, and weights made by the
benchmark, copied so the program never holds the reference's tensors."""

from __future__ import annotations

import torch


def autoencoder_config(config: dict):
    from repro_torch.core.autoencoder import AutoencoderConfig

    return AutoencoderConfig(input_dim=config["input_dim"], hidden=tuple(config["hidden"]),
                             latent_boundary=config["latent_boundary"],
                             timesteps=config["timesteps"])


def clone_tree(tree: dict) -> dict:
    return {k: clone_tree(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in tree.items()}


def reference_module(config: dict):
    from gwbench.harness import load_module

    return load_module("references", config["reference"])


def generator(seed: int, device: str) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)
