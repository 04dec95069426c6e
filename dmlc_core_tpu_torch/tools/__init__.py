"""Measurement scripts of the port, run on the card (not imported by the
package)."""
