"""Durability primitives the score stores and bitmask sinks commit
through (`repro_torch.durable.atomic`)."""
