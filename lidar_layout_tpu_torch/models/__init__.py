"""U-Net, VQ autoencoder, latent diffusion wrapper, schedules, samplers and the
sparse-voxel convolution block."""
