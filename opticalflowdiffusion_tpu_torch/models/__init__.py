"""Models (JAX ``models/``): the UNet and the diffusion samplers."""
