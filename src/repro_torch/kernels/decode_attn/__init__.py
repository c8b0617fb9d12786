"""Kernel 5: batched one-token GQA decode attention."""
