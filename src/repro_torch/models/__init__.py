"""Model code: layers, MLP, attention and the dense decoder."""
