"""Entry points of the port's LM substrate (serving so far)."""
