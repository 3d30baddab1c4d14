"""Diagonal-decay linear scan (Mamba2 / RWKV6): ``ops.linear_scan`` (the
wrapper, differentiable), ``ops.linear_scan_bwd`` (its gradient) and
``ref.linear_scan_ref`` / ``ref.linear_scan_bwd_ref`` (their plain
versions)."""
