"""User-facing drivers."""
