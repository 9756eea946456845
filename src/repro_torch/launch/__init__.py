"""Entry points: the fixed-batch serving driver."""
