"""lidar_layout_tpu_torch: the PyTorch / CUDA port of lidar_layout_tpu for one
NVIDIA H100 (Hopper, sm_90a).

The JAX package ``lidar_layout_tpu`` stays the reference; this package mirrors
its layout so each module's counterpart is found at once:

    ops/       LiDAR geometry, the Gaussian rasterizers and the hand-written
               kernels (``csrc/*.cu``)
    nn/        circular convs, blocks, embeddings, vector quantizer
    models/    U-Net, VQ autoencoders, latent diffusion, schedules, samplers,
               PT-v3 and the Gaussian-surfel dense decoder
    losses/    the autoencoder's VQ-GAN objective: geometry, discriminators
    utils/     device resolution, weight conversion from the JAX tree
    config.py  YAML -> model builders
    pipeline.py  GenerationPipeline: sample -> VQ decode -> reprojection

It imports torch and numpy, never jax or lidar_layout_tpu. Entry points run
on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
