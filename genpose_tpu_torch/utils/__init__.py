"""Device selection, weight conversion, logging, PNG files and tracking noise."""
