"""Runtime context threaded through the model code."""
