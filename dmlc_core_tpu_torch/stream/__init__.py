"""Streaming data: the ``Dataset`` composition layer (the port's own copy
of the JAX package's ``stream/dataset.py``)."""
