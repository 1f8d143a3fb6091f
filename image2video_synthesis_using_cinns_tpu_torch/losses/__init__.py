"""Training objectives (port of ``losses/``)."""
