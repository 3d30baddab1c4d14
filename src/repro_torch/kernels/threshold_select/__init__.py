"""Fused threshold selection: ascending indices of {A >= max(tau, 0)}."""
