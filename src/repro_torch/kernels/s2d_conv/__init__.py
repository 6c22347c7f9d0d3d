"""Fused D2S -> 1x1 conv -> S2D layer variant: plain torch version and Hopper kernel."""
