"""Checkpoints written through the query runtime (:mod:`.manager`)."""
