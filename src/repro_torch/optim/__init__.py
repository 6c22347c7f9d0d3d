"""The torch port's optimiser: AdamW with global-norm clipping and its schedule."""
