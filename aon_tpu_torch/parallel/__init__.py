"""Multi-process data parallelism: one process per GPU (``torch.distributed``)."""
