"""The port's benchmark: one command runs one cell (see README.md)."""
