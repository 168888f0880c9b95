"""Math helpers."""
