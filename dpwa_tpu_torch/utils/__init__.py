"""Flat parameters, devices and transport selection."""
