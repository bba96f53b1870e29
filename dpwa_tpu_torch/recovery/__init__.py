"""Recovery: the pre-merge payload guard (bootstrap, state transfer and
the rollback ring are not ported yet)."""
