"""Batched embedding extraction (one device)."""
