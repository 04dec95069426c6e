"""Streams and serialization (own copies; local files and mem://)."""
