"""Causal/non-causal GQA attention: ``ops.flash_attention`` (the wrapper)
and ``ref.attention_ref`` (its plain version)."""
