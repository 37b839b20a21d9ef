"""Architecture configs (torch dtypes)."""
