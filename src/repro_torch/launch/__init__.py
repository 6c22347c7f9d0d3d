"""Launchers of the torch port: the serving and the training entry points."""
