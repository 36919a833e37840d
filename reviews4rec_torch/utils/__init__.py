"""Artifact IO and device choice."""
