"""Support utilities of the port."""
