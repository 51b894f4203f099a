"""Global bundle adjustment sharded over a torch.distributed process group
(`distributed_ba`), and the multi-process entry that joins the group and
feeds each rank its own block (`multihost`)."""
