"""Processor stages of the port used by the point-cloud path."""
