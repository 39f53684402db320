"""Drivers of the cells' modes, found by the workload file's `mode`."""
