"""The torch port's training runtime: supervision and fault tolerance."""
