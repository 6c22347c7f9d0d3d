"""Model zoo of the torch port: every family of the registry, prefill, decode and loss."""
