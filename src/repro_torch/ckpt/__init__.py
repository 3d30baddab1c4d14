"""Checkpoints of the trainer's state, in the JAX package's format."""
