"""Checkpoint save and restore — port of ``repro.checkpoint``."""
