"""The 2D process grid and its distributed factor and solve."""
