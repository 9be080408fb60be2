"""The open-loop load generator and its statistics."""
