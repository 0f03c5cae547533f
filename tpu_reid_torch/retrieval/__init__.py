"""Distance matrices, CMC/mAP/mINP and k-reciprocal re-ranking."""
