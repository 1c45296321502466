"""Training objectives of the range autoencoder: geometry, discriminators, VQ-GAN."""
