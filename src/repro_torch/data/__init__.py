"""The torch port's synthetic data pipeline."""
