"""Chunk plans, score stores, selection sinks and synthetic corpora."""
