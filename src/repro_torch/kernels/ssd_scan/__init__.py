"""Mamba2 SSD chunked scan: plain torch versions and the Hopper kernel."""
