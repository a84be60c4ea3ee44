"""Data: augmentation, batch processing, eval-time image utilities and synthetic data."""
