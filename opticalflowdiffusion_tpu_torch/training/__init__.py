"""Training scripts (JAX ``training/``): the Autoencoder, flow and classifier
pretraining, the parity harnesses and the standalone diffusion trainer."""
