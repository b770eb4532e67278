"""Process-group helpers of the port (``torch.distributed``)."""
