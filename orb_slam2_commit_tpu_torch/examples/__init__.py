"""The port's command-line drivers (`python -m
orb_slam2_commit_tpu_torch.examples.run_dataset`)."""
