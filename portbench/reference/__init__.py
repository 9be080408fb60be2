"""The plain reference of SSH search and the comparison that decides
``correct``."""
