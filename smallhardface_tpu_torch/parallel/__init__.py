"""Data parallelism over processes: one process per card (``dist``)."""
