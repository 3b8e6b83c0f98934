"""Environments for closed-loop evaluation (host-side numpy)."""
