"""Marigold: diffusion-based affine-invariant depth (torch): the SD2 VAE,
the 8-channel-input UNet, the DDIM scheduler and test-time ensembling.
Port of ``depthmap_tpu/models/marigold/``."""
