"""Traffic generators: every input a cell sends, made from ``--seed``."""
