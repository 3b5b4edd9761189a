"""The float64 numpy oracle."""
