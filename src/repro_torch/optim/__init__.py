"""AdamW over a model's named parameters."""
