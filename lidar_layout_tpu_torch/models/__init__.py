"""U-Net, VQ autoencoders (with the Gaussian tower), latent diffusion wrapper,
schedules, samplers, the sparse-voxel convolution block, PT-v3 and the
Gaussian-surfel dense decoder."""
