"""Data parallelism: the data axis over a ``torch.distributed`` process
group (one process per GPU) and the rabit-shaped collectives on it."""
