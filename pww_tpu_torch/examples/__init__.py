"""Example scripts on the port, each runnable with ``python -m``."""
