"""Zero-shot ReID pipeline."""
