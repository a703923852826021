"""The yardstick: trace reduction, operation and byte counts, peaks.

Frozen copies, so that a later change to the program cannot change how
it is measured.
"""
