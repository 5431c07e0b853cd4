"""Dataset and build configurations."""
