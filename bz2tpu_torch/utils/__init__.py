"""Device selection helpers."""
