"""The polynomial CDC code families (host float64 control)."""
