"""Model zoo of the torch port: so far the dense decoder's decode path."""
