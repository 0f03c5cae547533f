"""Eval-path image preprocessing."""
