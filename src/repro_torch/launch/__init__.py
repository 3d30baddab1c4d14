"""Entry points that serve a model: batched proxy scoring (prefill)."""
