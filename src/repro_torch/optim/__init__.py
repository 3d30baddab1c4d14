"""The optimizer and gradient compression of the trainer."""
