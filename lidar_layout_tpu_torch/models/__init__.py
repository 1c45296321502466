"""U-Net, VQ autoencoder, latent diffusion wrapper, schedules and samplers."""
