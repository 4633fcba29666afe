"""Models (JAX ``models/``): the UNet and the diffusion samplers, the
Autoencoder, PWC-Net, RAFT, ResNet, MobileNetV2, the common small models and
the parameter EMA."""
