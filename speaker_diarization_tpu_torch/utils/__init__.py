"""Device selection and weight conversion."""
