"""The plain float32 reference of the benchmarked models (torch alone)."""
