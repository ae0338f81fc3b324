"""Frame-batched pipelines of the port."""
