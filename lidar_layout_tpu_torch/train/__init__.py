"""Training: optimizer, EMA update, checkpoints, the hook-driven loop and the LiDM CLI."""
