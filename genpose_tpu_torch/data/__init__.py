"""Data: augmentation, batch processing and synthetic batches."""
