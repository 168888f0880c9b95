"""Host-side asset helpers (numpy)."""
