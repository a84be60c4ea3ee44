"""Entry points: serving, training, single-frame evaluation and tracking."""
