"""Diagonal-decay linear scan (Mamba2 / RWKV6): ``ops.linear_scan`` (the
wrapper) and ``ref.linear_scan_ref`` (its plain version)."""
