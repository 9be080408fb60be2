"""Streams, windows and query pools made from the seed."""
