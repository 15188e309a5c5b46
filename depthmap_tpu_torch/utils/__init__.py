"""Utilities: checkpoint downloads, evaluation metrics, profiling spans."""
