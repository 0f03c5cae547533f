"""Distance matrices and CMC/mAP/mINP."""
