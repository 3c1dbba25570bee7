"""Entry points: ``serve`` (batched greedy / temperature decoding),
``steps`` (the one-device train step) and ``train`` (the fault-tolerant
trainer)."""
