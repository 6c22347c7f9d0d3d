"""The torch port's checkpoints, in the JAX package's msgpack layout."""
