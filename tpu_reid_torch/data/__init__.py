"""Eval-path image preprocessing, dataset parsers, attribute prompts and the batch loader."""
