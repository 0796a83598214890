"""Multi-GPU scaling (`mpcc_manipulator_tpu/parallel/`): scenario batches
split over the ranks of a ``torch.distributed`` process group."""
