"""Schedules and transports of the port."""
