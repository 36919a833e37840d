"""Evaluation (the trainer comes with a later slice)."""
