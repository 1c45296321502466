"""Conditioning encoders (counterpart of ``lidar_layout_tpu/encoders``)."""
