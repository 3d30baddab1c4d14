"""Fused score sketch: counts, Σ sqrt(A) and Σ A per score bin."""
