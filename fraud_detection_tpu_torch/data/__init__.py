"""Dataset loading and split indices."""
