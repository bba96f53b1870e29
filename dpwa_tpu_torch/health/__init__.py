"""Peer health: the fetch outcome classes (the health plane itself is not
ported yet)."""
