"""Quaternion, skeleton-state, robust-loss and small linear-algebra math."""
