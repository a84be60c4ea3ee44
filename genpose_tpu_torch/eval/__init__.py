"""Evaluation: pose error metrics."""
