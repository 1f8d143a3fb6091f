"""Trainers (port of ``train/``): stage-2 cINN training."""
