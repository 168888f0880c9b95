"""Blue noise (host, numpy)."""
