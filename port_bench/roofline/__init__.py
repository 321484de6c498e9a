"""Byte counts of the roofline shares, from the inputs' shapes alone."""
