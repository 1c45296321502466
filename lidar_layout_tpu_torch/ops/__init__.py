"""LiDAR geometry, voxel grids and space-filling-curve codes, and the
hand-written CUDA kernels with their plain versions."""
