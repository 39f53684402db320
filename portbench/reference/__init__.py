"""Plain PyTorch reference of the cells' model, training step and render."""
