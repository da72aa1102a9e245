"""The model: layers and the transformer."""
