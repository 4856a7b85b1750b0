"""Point stream and parameter conversion."""
