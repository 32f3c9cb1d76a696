"""Device selection and memory budgets."""
