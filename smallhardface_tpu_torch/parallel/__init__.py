"""Data parallelism over processes, one process per card or spatial unit
(``dist``), and spatial H-sharding over the devices of one process
(``spatial``)."""
