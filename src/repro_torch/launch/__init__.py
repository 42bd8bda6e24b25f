"""Entry points of the port's LLM substrate (serving, in this slice)."""
