"""Multi-device training and sampling on torch.distributed: the counterpart
of ``lidar_layout_tpu/parallel/`` (``collectives``, ``mesh``) and of the
multi-chip dry run (``dryrun``). One process per device, as ``torchrun``
starts them: NCCL on CUDA, gloo on the CPU."""
