"""Drivers: ``serve`` (batched greedy / temperature decoding)."""
