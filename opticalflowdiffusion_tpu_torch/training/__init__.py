"""Training scripts (JAX ``training/``): the Autoencoder pretraining."""
