"""Launchers of the torch port: so far the serving entry point."""
