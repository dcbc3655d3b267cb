"""Optimizers: AdamW with fp32 moments."""
